"""Host variance screen (`spca_run.dense_stats`): the benchmark's own span
around it, ms a fit, mean over the window's fits."""


def read(t):
    fits = t.run.fits
    return 1e3 * sum(f.t1 - f.t0 for f in fits) / len(fits) if fits else None
