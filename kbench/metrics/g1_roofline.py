"""g1_roofline: the least time of one MoE layer's routed experts at the
prefill tenant's shape (``call_work``: the gate, up and down products of
every (token, choice) pair; every expert's three matrices read once, the
pairs' rows read and written once, bf16) over the device time a call of
the port's grouped expert kernels (G1: its gate/up and down launches)
took in the profiled drains, in percent. Calls are counted on the first
kernel, one a MoE layer. A run without G1 reports nothing."""
from kbench import work
from kbench.trace import kernel_time

SYMBOLS = ("grouped_gate_up_kernel", "grouped_down_kernel")


def call_work(tokens: int, model: dict, elt: int = 2):
    """(FLOPs, bytes) of one MoE layer's routed experts over ``tokens``
    tokens: 2 x 3 x d_model x d_ff_expert FLOPs a pair, top_k pairs a
    token; the experts' wi, wg and wo read once and each pair's row read
    and its output row written once."""
    m = model["moe"]
    d, f, e = model["d_model"], m["d_ff_expert"], m["num_experts"]
    pairs = tokens * m["top_k"]
    return 6.0 * pairs * d * f, 3 * e * d * f * elt + 2 * pairs * d * elt


def read(rec):
    t, m = rec["trace"], rec["model"]
    pre = [x for x in rec["tenants"] if x["phase"] == "prefill"]
    if not t or not pre or not m.get("moe"):
        return None
    seconds, calls = kernel_time(t["kernels"], *SYMBOLS)
    if not calls:
        return None
    flops, nbytes = call_work(pre[0]["batch"] * pre[0]["seq"], m)
    return 100.0 * work.bound(flops, nbytes, "bfloat16")[0] \
        / (1e3 * seconds / calls)
