"""k4_roofline: the chunked WKV6 scan's least time at the prefill tenant's
shape (``work.wkv6_work``, bf16 r/k/v) over the device time a call of the
port's two WKV6 passes (K4) took in the profiled drains, in percent."""
from kbench import work
from kbench.trace import kernel_time

SYMBOLS = ("wkv6_states_kernel", "wkv6_out_kernel")


def read(rec):
    t, m = rec["trace"], rec["model"]
    pre = [x for x in rec["tenants"] if x["phase"] == "prefill"]
    if not t or not pre or "rwkv_head_dim" not in m:
        return None
    seconds, calls = kernel_time(t["kernels"], *SYMBOLS)
    if not calls:
        return None
    x, n = pre[0], m["rwkv_head_dim"]
    products, other, nbytes = work.wkv6_work(
        x["batch"], x["seq"], m["d_model"] // n, n, 2)
    return 100.0 * work.wkv6_bound_ms(products, other, nbytes)[0] \
        / (1e3 * seconds / calls)
