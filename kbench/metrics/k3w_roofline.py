"""k3w_roofline: the least time of one windowed causal attention call at
the prefill tenant's shape (``call_work``: the (query, key) pairs a window
of ``local_window`` keys leaves, bf16) over the device time a call of the
port's windowed flash-attention kernel (K3's ``flash_fwd_window_kernel``,
one call a sliding-window layer) took in the profiled drains, in percent.
A run without that kernel reports nothing."""
from kbench import work
from kbench.trace import kernel_time

SYMBOLS = ("flash_fwd_window_kernel",)


def call_work(shape, window: int, kv_heads: int, elt: int = 2):
    """(FLOPs, bytes) of one call at (B, H, S, D) over keys q - k <
    ``window``: two products of 2D FLOPs a (head, query, key) pair, sum
    over q of min(q + 1, window) pairs a row; q and the output read and
    written once at H heads, k and v read once at ``kv_heads``."""
    b, h, s, d = shape
    w = min(window, s)
    pairs = work.causal_pairs(w) + (s - w) * w
    return 4.0 * d * pairs * b * h, 2 * b * (h + kv_heads) * s * d * elt


def read(rec):
    t, m = rec["trace"], rec["model"]
    pre = [x for x in rec["tenants"] if x["phase"] == "prefill"]
    if not t or not pre or not m.get("local_window"):
        return None
    seconds, calls = kernel_time(t["kernels"], *SYMBOLS)
    if not calls:
        return None
    x = pre[0]
    flops, nbytes = call_work(
        (x["batch"], m["num_heads"], x["seq"], m["head_dim"]),
        m["local_window"], m["num_kv_heads"])
    return 100.0 * work.bound(flops, nbytes, "bfloat16")[0] \
        / (1e3 * seconds / calls)
