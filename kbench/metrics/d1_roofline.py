"""d1_roofline: one decode token's attention over the valid cache rows at
the decode tenant's shape (``work.decode_work``, bf16 cache) over the device
time a call of the port's decode-attention kernel (D1) and its combine took
in the profiled drains, in percent."""
from kbench import work
from kbench.trace import kernel_time

SYMBOLS = ("decode_attention_kernel", "decode_combine_kernel")


def read(rec):
    t, m = rec["trace"], rec["model"]
    dec = [x for x in rec["tenants"] if x["phase"] == "decode"]
    if not t or not dec or "head_dim" not in m:
        return None
    seconds, calls = kernel_time(t["kernels"], *SYMBOLS)
    if not calls:
        return None
    x = dec[0]
    flops, nbytes = work.decode_work(
        x["batch"], m["num_heads"], m["num_kv_heads"],
        work.decode_position(x["seq"]) + 1, m["head_dim"], 2)
    return 100.0 * work.bound(flops, nbytes, "bfloat16")[0] \
        / (1e3 * seconds / calls)
