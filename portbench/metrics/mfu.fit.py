"""The whole fit: the operations a fit needs (each K1 launch's, counted
from its shapes and the sweeps it reported; each reduced Gram's, a
multiply and an add for each of the k (k + 1) / 2 entries over m
documents; the screen's three a nonzero) over the traced window's
seconds at the card's float32 rate, in %.  It bounds the kernels'
rooflines: a kernel taken off the path leaves its own roofline silent,
not this."""
from portbench import yardstick as ys


def read(t):
    fits = t.run.fits
    if not fits or not t.launches["k1"] or t.window_s <= 0:
        return None
    ops = 0
    for L in t.launches["k1"]:
        sweeps = L["meta"][:, 1].detach().cpu().tolist()
        n_valid = L["n_valid"].detach().cpu().tolist()
        ops += sum(ys.k1_ops(int(n), L["qp_sweeps"], L["tau_iters"], int(s))
                   for n, s in zip(n_valid, sweeps))
    m, nnz = t.run.bag.n_docs, t.run.bag.nnz
    for f in fits:
        ops += 3 * nnz
        ops += sum(m * len(s) * (len(s) + 1) for s, _ in f.grams)
    return 100.0 * ops / (t.window_s * ys.H100_F32_FLOPS)
