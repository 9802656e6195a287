"""k3_roofline: causal attention's least time at the prefill tenant's
shape (``work.k3_work``, bf16) over the device time a call of the port's
flash-attention kernel (K3) took in the profiled drains, in percent."""
from kbench import work
from kbench.trace import kernel_time

SYMBOLS = ("flash_fwd_wgmma_kernel",)


def read(rec):
    t, m = rec["trace"], rec["model"]
    pre = [x for x in rec["tenants"] if x["phase"] == "prefill"]
    if not t or not pre or "head_dim" not in m:
        return None
    seconds, calls = kernel_time(t["kernels"], *SYMBOLS)
    if not calls:
        return None
    x = pre[0]
    flops, nbytes = work.k3_work(
        (x["batch"], m["num_heads"], x["seq"], m["head_dim"]), True)
    return 100.0 * work.bound(flops, nbytes, "bfloat16")[0] \
        / (1e3 * seconds / calls)
