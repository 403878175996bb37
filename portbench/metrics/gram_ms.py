"""Reduced Gram (`core.spca.ReducedCovarianceCache`): the program's
``cov.build`` spans (device-synced while tracing), ms summed a fit."""


def read(t):
    spans = t.tracer.find("cov.build")
    fits = len(t.run.fits)
    if not spans or not fits:
        return None
    return 1e3 * sum(s.total_s for s in spans) / fits
