"""Driver (`core.spca`): solve launches a fit, as the fit's diagnostics
count them (one an evaluation, or one a batched round)."""


def read(t):
    fits = t.run.fits
    if not fits:
        return None
    return sum(f.diag["solve_launches"] for f in fits) / len(fits)
