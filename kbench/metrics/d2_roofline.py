"""d2_roofline: the least time of one absorbed MLA decode call at the decode
tenant's shape (every valid latent row of ckv and krope read once, bf16;
``call_work``) over the device time a call of the port's latent-attention
kernel (D2) and its merge took in the profiled drains, in percent. The
queries and the f32 partials, under 1% of the bytes at the cell's shape,
are left out. A run without D2 reports nothing."""
from kbench import work
from kbench.trace import kernel_time

SYMBOLS = ("mla_decode_kernel", "mla_combine_kernel")


def call_work(batch: int, heads: int, rows: int, mla: dict, elt: int = 2):
    """(FLOPs, bytes) of one call over ``rows`` valid latent rows: the
    scores' 2 (R + DR) and the output's 2 R FLOPs a (head, row); each ckv
    (R) and krope (DR) row read once."""
    r, dr = mla["kv_lora_rank"], mla["qk_rope_dim"]
    return (2.0 * batch * heads * rows * (2 * r + dr),
            batch * rows * (r + dr) * elt)


def read(rec):
    t, m = rec["trace"], rec["model"]
    dec = [x for x in rec["tenants"] if x["phase"] == "decode"]
    if not t or not dec or not m.get("mla"):
        return None
    seconds, calls = kernel_time(t["kernels"], *SYMBOLS)
    if not calls:
        return None
    x = dec[0]
    flops, nbytes = call_work(x["batch"], m["num_heads"],
                              work.decode_position(x["seq"]) + 1, m["mla"])
    return 100.0 * work.bound(flops, nbytes, "bfloat16")[0] \
        / (1e3 * seconds / calls)
