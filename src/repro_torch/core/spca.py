"""High-level sparse-PCA driver: eliminate -> solve -> extract, with the
paper's lambda search and multi-component deflation (port of
``repro.core.spca``).

The pipeline:

  1. per-feature variances                                        (O(nm))
  2. safe elimination at lambda (Thm 2.1)   -> support, n_hat << n
  3. reduced covariance Sigma_hat on the support                  (O(n_hat^2 m))
  4. block coordinate ascent on Sigma_hat                         (O(K n_hat^3))
  5. leading eigenvector of Z -> sparse component, embedded back into R^n

Deflation 'remove' drops the selected words between components (the
paper's disjoint topics); 'project' is Hotelling deflation.

Tensors live on one device: the device of the tensors given, else
``device`` (the card by default).  Supports and loadings in `PCResult` are
host numpy arrays, as in the reference.

With ``SPCAConfig.resume_dir`` a fit checkpoints as the reference's does:
its corpus passes at megabatch boundaries (`sparse.resume`), every
completed component and the active lambda search's cursor
(`core.fitstate`), so a killed fit run again resumes at the last
component/eval boundary with the same results.  ``solve_deadline_s``
arms a watchdog over each search round, checked after that round's
checkpoint.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..device import as_tensor, to_host
from ..obs import health, metrics, trace
from . import bcd, elimination, validate


@dataclass
class PCResult:
    x: np.ndarray            # sparse loading vector in the ORIGINAL feature space
    support: np.ndarray      # indices of nonzero loadings
    lam: float
    variance: float          # explained variance x^T Sigma x
    cardinality: int
    reduced_n: int           # problem size after safe elimination
    gap: float               # duality-gap certificate on the reduced problem
    sweeps: int = 0
    fallbacks: int = 0       # whole-matrix re-solves the supervisor took
    # Reduced-problem state for warm starts and the batched deflation
    # re-polish: the feature indices of Sigma_hat's rows, and (only when
    # requested via ``keep_reduced``) the solver iterate X and Sigma_hat on
    # that support, as tensors on the fit's device.
    reduced_support: np.ndarray | None = field(default=None, repr=False)
    X_reduced: torch.Tensor | None = field(default=None, repr=False)
    Sigma_reduced: torch.Tensor | None = field(default=None, repr=False)


@dataclass
class SPCAConfig:
    """The reference's configuration, field for field, so a config dict
    carries across (`repro_torch.convert.from_reference`).  The two fields
    whose machinery is not ported yet (``mesh_devices``,
    ``lam_grid_probe``) raise `NotImplementedError` when set (see
    `check_config`); the out-of-core fields (``chunk_nnz`` ...
    ``io_backoff_s``, ``checkpoint_every``, ``pass_deadline_s``) only
    matter to a store handle.  ``resume_dir`` checkpoints the passes and
    the fit (``fit_checkpoint_every`` evals/rounds between search
    cursors); ``solve_deadline_s`` bounds each search round.
    ``csr_impl`` is the CSR wrappers' ``impl``: 'auto' | 'cuda' | 'ref'."""

    center: bool = True
    max_reduced: int = 2048
    max_sweeps: int = 20
    qp_sweeps: int = 4
    tol: float = 1e-7
    beta: float | None = None
    support_rel_tol: float = 1e-2
    lam_search_evals: int = 12
    card_slack: int = 2          # accept cardinality in [target, target+slack]
    tau_iters: int = 80
    qp_impl: str = "jnp"         # 'jnp' | 'pallas' (per-row kernel K7)
    solver_impl: str = "auto"    # 'auto' | 'jnp' | 'fused' | 'fused_ref'
    reuse_covariance: bool = True
    warm_start: bool = True
    lam_grid_probe: int = 0
    grid_probe_max_n: int = 512
    panel_rows: int = 0          # the TPU tiled kernel's panel height
    batch_evals: int = 0         # >1: each search round is ONE batched launch
    batch_deflation: bool = False
    support_bucketing: bool = True
    support_buckets: tuple = (
        16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536,
        2048,
    )
    chunk_nnz: int = 16_384
    chunk_rows: int = 512
    csr_impl: str = "auto"
    megabatch_chunks: int = 8
    ingest_prefetch: int = 2
    io_retries: int = 2
    io_backoff_s: float = 0.05
    resume_dir: str | None = None
    checkpoint_every: int = 16
    solver_fallback: bool = True
    debris_dir: str | None = None
    fit_checkpoint_every: int = 1
    mesh_min_devices: int = 1
    pass_deadline_s: float | None = None
    solve_deadline_s: float | None = None
    mesh_devices: int = 0
    data_parallel: bool = True


def check_config(cfg: SPCAConfig) -> None:
    """Refuse the fields whose machinery this port does not have yet,
    naming the ROADMAP item that ports it."""
    todo = {
        "mesh_devices": (cfg.mesh_devices > 1, "queue 1 item 12 (mesh)"),
        "lam_grid_probe": (cfg.lam_grid_probe > 1,
                           "queue 1 item 15 (grid probe)"),
    }
    for name, (on, item) in todo.items():
        if on:
            raise NotImplementedError(
                f"SPCAConfig.{name} is not ported yet: ROADMAP {item}")
    bcd.check_qp_impl(cfg.qp_impl)
    if cfg.panel_rows:
        raise ValueError("SPCAConfig.panel_rows is the TPU tiled kernel's "
                         "Sigma panel height; the Hopper kernel has none")


def _as_stats(data, is_covariance: bool, center: bool, device=None,
              cfg: SPCAConfig | None = None, counters: dict | None = None):
    """Normalise input to (variances, reduced-covariance builder): a dense
    (m, n) data matrix or an (n, n) covariance (``is_covariance=True``),
    as a tensor or numpy array, or an out-of-core `sparse.SparseCorpus`
    store handle (duck-typed on ``iter_chunks``), whose two streaming
    passes run through the CSR kernels on ``device`` and never
    materialise an (m, n) array.  ``counters``, with a store handle,
    collects the ingest pass/launch tallies (see `sparse.engine`)."""
    if hasattr(data, "iter_chunks"):
        from ..sparse import engine

        cfg = cfg if cfg is not None else SPCAConfig()
        return engine.sparse_stats(
            data, center=center, impl=cfg.csr_impl,
            chunk_nnz=cfg.chunk_nnz, chunk_rows=cfg.chunk_rows,
            megabatch=cfg.megabatch_chunks,
            prefetch_depth=cfg.ingest_prefetch, counters=counters,
            io_retries=cfg.io_retries, io_backoff_s=cfg.io_backoff_s,
            resume_dir=cfg.resume_dir, checkpoint_every=cfg.checkpoint_every,
            pass_deadline_s=cfg.pass_deadline_s, device=device)
    if is_covariance:
        Sigma = as_tensor(data, device)

        def build(support):
            idx = torch.as_tensor(np.asarray(support), device=Sigma.device)
            return Sigma.index_select(0, idx).index_select(1, idx)

        return torch.diagonal(Sigma).cpu().numpy(), build
    A = as_tensor(data, device)
    screen = elimination.feature_variances(A, center=center)

    def build(support):
        idx = torch.as_tensor(np.asarray(support), device=A.device)
        cols = A.index_select(1, idx)
        if center:
            cols = cols - screen.means.index_select(0, idx)[None, :]
        return elimination.reduced_covariance(cols)

    return screen.variances.cpu().numpy(), build


def _debris_dir(cfg: SPCAConfig) -> str | None:
    if cfg.debris_dir:
        return cfg.debris_dir
    if cfg.resume_dir:
        return os.path.join(cfg.resume_dir, "debris")
    return None


def _solve_watchdog(cfg: SPCAConfig):
    """The ``solve_deadline_s`` watchdog over one search round, or None."""
    if cfg.solve_deadline_s is None:
        return None
    return health.Watchdog(cfg.solve_deadline_s, what="solve round",
                           exc=health.SolveDeadlineError)


def _pack_pc(r: PCResult) -> dict:
    """PCResult -> the JSON + ndarray tree `core.fitstate` serializes (the
    reference's keys; tensors brought to the host)."""
    d = {
        "x": np.asarray(r.x), "support": np.asarray(r.support),
        "lam": float(r.lam), "variance": float(r.variance),
        "cardinality": int(r.cardinality), "reduced_n": int(r.reduced_n),
        "gap": float(r.gap), "sweeps": int(r.sweeps),
        "fallbacks": int(r.fallbacks),
    }
    for name in ("reduced_support", "X_reduced", "Sigma_reduced"):
        val = getattr(r, name)
        if val is not None:
            d[name] = to_host(val)
    return d


def _unpack_pc(d: dict, device=None) -> PCResult:
    """Inverse of `_pack_pc`; the reduced iterate and Sigma_hat go back to
    ``device`` as tensors, unchanged."""
    def arr(name):
        v = d.get(name)
        return None if v is None else as_tensor(v, device)

    rs = d.get("reduced_support")
    return PCResult(
        x=np.asarray(d["x"]), support=np.asarray(d["support"], np.int64),
        lam=float(d["lam"]), variance=float(d["variance"]),
        cardinality=int(d["cardinality"]), reduced_n=int(d["reduced_n"]),
        gap=float(d["gap"]), sweeps=int(d["sweeps"]),
        fallbacks=int(d.get("fallbacks", 0)),
        reduced_support=None if rs is None else np.asarray(rs, np.int64),
        X_reduced=arr("X_reduced"), Sigma_reduced=arr("Sigma_reduced"),
    )


def _variance_order(v: np.ndarray) -> np.ndarray:
    """Available features in stable variance-descending order (ties break
    toward the lower index): the prefix of length t is the support any
    Thm 2.1 screen of size t selects."""
    avail = np.flatnonzero(np.isfinite(v) & (v > 0))
    return avail[np.argsort(-v[avail], kind="stable")]


def _buckets_of(cfg: SPCAConfig):
    return cfg.support_buckets if cfg.support_bucketing else None


def _support_at(v: np.ndarray, lam: float, max_reduced: int,
                buckets=None) -> np.ndarray:
    """Surviving-feature indices at ``lam`` (Thm 2.1 screen on masked
    variances ``v``) with the solver-size guard, topped up with ``buckets``
    to the next bucket size with the highest-variance screened-out
    features (safe by Thm 2.1: their loadings come back zero).  Supports
    stay nested in lambda."""
    support = elimination.select_support(v, lam, max_reduced)
    if buckets is None:
        return support
    k = support.size
    target = next((int(b) for b in buckets if b >= k), k)
    if max_reduced is not None:
        target = min(target, max_reduced)
    if target <= k:
        return support
    order = _variance_order(v)
    if order.size <= k:
        return support
    return np.union1d(support, order[:min(target, order.size)])


def _principal(S: torch.Tensor, pos) -> torch.Tensor:
    idx = torch.as_tensor(np.asarray(pos), device=S.device)
    return S.index_select(0, idx).index_select(1, idx)


class ReducedCovarianceCache:
    """Sigma_hat cache across the nested supports of a lambda search: built
    ONCE at the smallest lambda evaluated so far, and every evaluation at a
    larger lambda slices its principal submatrix out of it (an entry of a
    Gram matrix depends only on its own column pair, so the slice equals a
    rebuild).  A support that escapes the base falls back to a rebuild
    that re-seeds the cache.  ``builds``/``slices`` count both."""

    def __init__(self, build, device=None):
        self._build = build
        self._device = device
        self._support: np.ndarray | None = None
        self._sigma: torch.Tensor | None = None
        self.builds = 0
        self.slices = 0

    def get(self, support: np.ndarray) -> torch.Tensor:
        support = np.asarray(support)
        if self._support is not None and support.size <= self._support.size:
            if support.size == self._support.size and np.array_equal(
                support, self._support
            ):
                self.slices += 1
                metrics.counter("cov.slices").inc()
                return self._sigma
            pos = np.searchsorted(self._support, support)
            pos = np.minimum(pos, self._support.size - 1)
            if np.array_equal(self._support[pos], support):
                self.slices += 1
                metrics.counter("cov.slices").inc()
                return _principal(self._sigma, pos)
        self.builds += 1
        metrics.counter("cov.builds").inc()
        self._support = support
        with trace.span("cov.build", n_hat=int(support.size)):
            self._sigma = as_tensor(self._build(support), self._device)
            trace.device_sync(self._sigma)
        return self._sigma


def _warm_x0(support: np.ndarray, prev_X, prev_support, Sigma_hat):
    """Embed the previous lambda's iterate into the new support: the common
    block keeps the previous (PD) principal submatrix, entering features
    start at the identity (block diagonal up to permutation, hence PD)."""
    if prev_X is None or prev_support is None:
        return None
    common, ia, ib = np.intersect1d(
        support, prev_support, assume_unique=True, return_indices=True
    )
    if common.size == 0:
        return None
    dev = Sigma_hat.device
    X0 = torch.eye(support.size, dtype=Sigma_hat.dtype, device=dev)
    ia_t = torch.as_tensor(ia, device=dev)
    X0[ia_t[:, None], ia_t[None, :]] = _principal(
        prev_X.to(device=dev, dtype=Sigma_hat.dtype), ib)
    return X0


def solve_at_lambda(
    data,
    lam: float,
    *,
    is_covariance: bool = False,
    cfg: SPCAConfig | None = None,
    active_mask: np.ndarray | None = None,
    stats=None,
    cov_cache: ReducedCovarianceCache | None = None,
    warm: tuple | None = None,
    keep_reduced: bool = False,
    device=None,
) -> PCResult:
    """Full pipeline for one lambda.  ``active_mask`` masks deflated
    features; ``cov_cache`` slices the reduced covariance instead of
    rebuilding it; ``warm`` is a ``(X_reduced, reduced_support)`` pair to
    warm-start the solver; ``keep_reduced`` keeps the solver iterate."""
    if cfg is None:
        cfg = SPCAConfig()
    check_config(cfg)
    if stats is None:
        stats = _as_stats(data, is_covariance, cfg.center, device, cfg)
    variances, build = stats
    v = np.array(variances, copy=True)
    if active_mask is not None:
        v = np.where(active_mask, v, -np.inf)
    support = _support_at(v, lam, cfg.max_reduced, _buckets_of(cfg))
    Sigma_hat = (cov_cache.get(support) if cov_cache is not None
                 else as_tensor(build(support), device))
    X0 = None
    if warm is not None and cfg.warm_start:
        X0 = _warm_x0(support, warm[0], warm[1], Sigma_hat)
    fallbacks = 0
    kw = dict(beta=cfg.beta, max_sweeps=cfg.max_sweeps,
              qp_sweeps=cfg.qp_sweeps, tol=cfg.tol, tau_iters=cfg.tau_iters,
              X0=X0, qp_impl=cfg.qp_impl, solver_impl=cfg.solver_impl)
    with trace.span("solver.eval", lam=float(lam), n_hat=int(support.size),
                    warm=X0 is not None):
        if cfg.solver_fallback:
            res, fallbacks = bcd.solve_bcd_supervised(
                Sigma_hat, lam, debris_dir=_debris_dir(cfg), **kw)
        else:
            res = bcd.solve_bcd(Sigma_hat, lam, **kw)
    x_red = bcd.leading_sparse_component(res.Z, rel_tol=cfg.support_rel_tol)
    gap = float(validate.kkt_gap(res.X, Sigma_hat, lam, res.beta)[0])
    x = np.zeros(variances.shape[0])
    x[support] = x_red.cpu().numpy()
    nz = np.flatnonzero(x)
    sweeps = int(res.sweeps)
    metrics.histogram("solver.sweeps").observe(sweeps)
    if not cfg.solver_fallback:
        bcd.observe_result_health(res, max_sweeps=cfg.max_sweeps)
    return PCResult(
        x=x, support=nz, lam=float(lam),
        variance=float(x_red @ Sigma_hat @ x_red),
        cardinality=int(nz.size), reduced_n=int(support.size), gap=gap,
        sweeps=sweeps, fallbacks=fallbacks, reduced_support=support,
        X_reduced=res.X if keep_reduced else None,
        Sigma_reduced=Sigma_hat if keep_reduced else None,
    )


def _card_better(cfg: SPCAConfig, target_card: int):
    """Candidate ordering shared by the sequential and batched searches:
    cardinality in [target, target+slack] first, else closest, then
    higher explained variance."""
    def key(c):
        card = c.cardinality if hasattr(c, "cardinality") else c["cardinality"]
        var = c.variance if hasattr(c, "variance") else c["variance"]
        dist = (0 if target_card <= card <= target_card + cfg.card_slack
                else abs(card - target_card))
        return dist, -var

    def better(a, b) -> bool:
        return b is None or key(a) < key(b)
    return better


def _bracket_depth(target_card: int, size: int) -> int:
    """Variance rank the bracket's lo threshold is pinned at."""
    return min(max(30 * target_card, 100), size)


def _search_bracket(v: np.ndarray, target_card: int) -> tuple[float, float]:
    """Initial (lo, hi) lambda bracket from the masked variance spectrum."""
    vs = np.sort(v[np.isfinite(v) & (v > 0)])[::-1]
    hi = float(vs[0]) * 0.999     # keeps >=1 feature
    lo = float(max(vs[_bracket_depth(target_card, vs.size) - 1], 1e-12))
    return lo, hi


def search_lambda(
    data,
    target_card: int,
    *,
    is_covariance: bool = False,
    cfg: SPCAConfig | None = None,
    active_mask: np.ndarray | None = None,
    stats=None,
    diagnostics: dict | None = None,
    keep_reduced: bool = False,
    cov_cache: ReducedCovarianceCache | None = None,
    device=None,
    fit_ckpt=None,
    component_k: int = 0,
) -> PCResult:
    """Geometric bisection on lambda for a solution with cardinality in
    [target_card, target_card + card_slack], keeping the best candidate.

    Evaluations share one reduced covariance (`ReducedCovarianceCache`),
    warm-start from the previous solution and see bucketed supports.  With
    ``cfg.batch_evals > 1`` each round solves a whole geometric lambda grid
    as ONE batched launch instead.  ``diagnostics`` is filled with the
    eval/build/warm/launch counters; ``cov_cache`` injects a cache shared
    across searches (its build/slice deltas are reported).  ``fit_ckpt``
    (a `fitstate.FitCheckpointer`) restores component ``component_k``'s
    saved cursor, so the search runs exactly the remaining evaluations of
    the uninterrupted one, and records the cursor after every evaluation
    (batched: round); `SPCAConfig.solve_deadline_s` is checked after
    that record."""
    if cfg is None:
        cfg = SPCAConfig()
    check_config(cfg)
    if stats is None:
        stats = _as_stats(data, is_covariance, cfg.center, device, cfg)
    if cfg.batch_evals > 1:
        return _search_lambda_batched(
            target_card, cfg=cfg, active_mask=active_mask, stats=stats,
            diagnostics=diagnostics, keep_reduced=keep_reduced,
            cov_cache=cov_cache, device=device, fit_ckpt=fit_ckpt,
            component_k=component_k,
        )
    variances, build = stats
    v = np.array(variances, copy=True)
    if active_mask is not None:
        v = np.where(active_mask, v, -np.inf)
    lo, hi = _search_bracket(v, target_card)

    cache = cov_cache
    if cache is None and cfg.reuse_covariance:
        cache = ReducedCovarianceCache(build, device)
    builds0 = cache.builds if cache is not None else 0
    slices0 = cache.slices if cache is not None else 0

    # Resume: a saved cursor restores the bracket, the eval count, the
    # incumbent and the warm block; the search then runs exactly the
    # remaining evaluations of the uninterrupted one.
    best: PCResult | None = None
    warm: tuple | None = None
    start_eval = evals_skipped = fallbacks = 0
    hit = False
    cursor = (fit_ckpt.search_cursor(component_k) if fit_ckpt is not None
              else None)
    if cursor is not None:
        lo, hi = float(cursor["lo"]), float(cursor["hi"])
        start_eval = evals_skipped = int(cursor["evals"])
        hit = bool(cursor.get("done", False))
        fallbacks = int(cursor.get("fallbacks", 0))
        if cursor.get("best") is not None:
            best = _unpack_pc(cursor["best"], device)
        if cfg.warm_start and cursor.get("warm_X") is not None:
            warm = (as_tensor(cursor["warm_X"], device),
                    np.asarray(cursor["warm_support"], np.int64))
        metrics.counter("fit.resume.evals_skipped").inc(evals_skipped)

    evals = warm_starts = total_sweeps = 0
    better = _card_better(cfg, target_card)
    for i in range(start_eval, cfg.lam_search_evals):
        if hit:
            break
        wd = _solve_watchdog(cfg)
        lam = float(np.sqrt(lo * hi))  # geometric: variances span decades
        r = solve_at_lambda(
            data, lam, is_covariance=is_covariance, cfg=cfg,
            active_mask=active_mask, stats=stats, cov_cache=cache,
            warm=warm, keep_reduced=cfg.warm_start or keep_reduced,
            device=device,
        )
        evals += 1
        total_sweeps += r.sweeps
        fallbacks += r.fallbacks
        if warm is not None and cfg.warm_start:
            warm_starts += 1
        if cfg.warm_start:
            warm = (r.X_reduced, r.reduced_support)
        if better(r, best):
            best = r
        hit = target_card <= r.cardinality <= target_card + cfg.card_slack
        if not hit:
            if r.cardinality > target_card:
                lo = lam   # too dense -> raise lambda
            else:
                hi = lam   # too sparse -> lower lambda
        if fit_ckpt is not None:
            # before the watchdog can raise: a deadline kill resumes too
            fit_ckpt.record_search({
                "k": int(component_k), "evals": i + 1,
                "lo": float(lo), "hi": float(hi), "done": bool(hit),
                "fallbacks": int(fallbacks), "best": _pack_pc(best),
                "warm_X": None if warm is None or warm[0] is None
                else to_host(warm[0]),
                "warm_support": None if warm is None or warm[1] is None
                else np.asarray(warm[1]),
            })
        if wd is not None:
            wd.check()
    assert best is not None
    metrics.counter("search.evals").inc(evals)
    metrics.counter("search.warm_starts").inc(warm_starts)
    metrics.counter("solver.launches").inc(evals)
    if diagnostics is not None:
        diagnostics.update(
            evals=evals,
            warm_starts=warm_starts,
            total_sweeps=total_sweeps,
            cov_builds=cache.builds - builds0 if cache is not None else evals,
            cov_slices=cache.slices - slices0 if cache is not None else 0,
            solve_launches=evals,
            batched=False,
            evals_skipped=evals_skipped,
            fallbacks=fallbacks,
        )
    best = replace(best, fallbacks=fallbacks)
    if keep_reduced:
        return best
    return replace(best, X_reduced=None, Sigma_reduced=None)


def _batched_impl(solver_impl: str) -> str:
    """SPCAConfig.solver_impl -> the batched op's impl.  There is no
    separate whole-matrix program for batches: 'jnp' takes the op's
    default (the kernel on the card, its plain version on the CPU),
    'fused_ref' the plain version, 'fused' the kernel."""
    return {"fused_ref": "ref", "fused": "cuda"}.get(solver_impl, "auto")


def _pack_batched_best(best: dict) -> dict:
    """The batched search's incumbent as a serializable tree (the
    reference's keys): the winning iterate X and the scalars the final
    PCResult assembly reads."""
    res = best["res"]
    return {
        "lam": float(best["lam"]), "t": int(best["t"]),
        "cardinality": int(best["cardinality"]),
        "variance": float(best["variance"]),
        "x_red": to_host(best["x_red"]),
        "X": to_host(res.X), "beta": float(res.beta),
        "sweeps": int(res.sweeps),
    }


def _unpack_batched_best(d: dict, cfg: SPCAConfig, device=None) -> dict:
    """Inverse of `_pack_batched_best`: the minimal `BCDResult` the search
    tail needs (X, beta, sweeps; obj/phi/history were consumed by the
    evaluation that produced them, so they come back as NaN)."""
    X = as_tensor(d["X"], device)
    nan = torch.tensor(float("nan"), dtype=X.dtype, device=X.device)
    res = bcd.BCDResult(
        X=X, Z=X / torch.trace(X), obj=nan, phi=nan,
        history=torch.full((cfg.max_sweeps,), float("nan"), dtype=X.dtype,
                           device=X.device),
        sweeps=torch.tensor(int(d["sweeps"])), beta=float(d["beta"]))
    return {
        "lam": float(d["lam"]), "t": int(d["t"]), "res": res,
        "x_red": as_tensor(d["x_red"], X.device),
        "cardinality": int(d["cardinality"]),
        "variance": float(d["variance"]),
    }


def _search_lambda_batched(
    target_card: int,
    *,
    cfg: SPCAConfig,
    active_mask: np.ndarray | None,
    stats,
    diagnostics: dict | None,
    keep_reduced: bool = False,
    cov_cache: ReducedCovarianceCache | None = None,
    device=None,
    fit_ckpt=None,
    component_k: int = 0,
) -> PCResult:
    """Lambda search as O(rounds) batched launches instead of O(evals).

    Every evaluation of a round solves on a nested *prefix* of the shared
    base support ordered by descending variance (Thm 2.1), so a round is B
    independent problems — one `ops.bcd_solve_batched` launch — and the
    bracket tightens from the B cardinalities at once."""
    variances, build = stats
    v = np.array(variances, copy=True)
    if active_mask is not None:
        v = np.where(active_mask, v, -np.inf)
    lo, hi = _search_bracket(v, target_card)
    n_features = variances.shape[0]

    cache = cov_cache
    if cache is None and cfg.reuse_covariance:
        cache = ReducedCovarianceCache(build, device)
    builds0 = cache.builds if cache is not None else 0
    slices0 = cache.slices if cache is not None else 0
    base_support = _support_at(v, lo, cfg.max_reduced, _buckets_of(cfg))
    Sigma_base = (cache.get(base_support) if cache is not None
                  else as_tensor(build(base_support), device))
    # Variance-descending order turns every nested support into a prefix.
    order = np.argsort(-v[base_support], kind="stable")
    feat_perm = base_support[order]
    Sigma_perm = _principal(Sigma_base, order)
    dtype, dev = Sigma_perm.dtype, Sigma_perm.device

    B = cfg.batch_evals
    rounds = max(1, -(-cfg.lam_search_evals // B))
    better = _card_better(cfg, target_card)
    best: dict | None = None
    warm: tuple | None = None     # (X on prefix, prefix length)
    evals = launches = warm_starts = total_sweeps = 0

    # Resume: the cursor restores the tightened bracket, the round and
    # eval counts, the incumbent and the warm block.  The base support
    # above comes from the INITIAL bracket, as in the uninterrupted run, so
    # restored prefix lengths index the same feat_perm order.
    start_round = evals_skipped = fallbacks = 0
    hit = False
    cursor = (fit_ckpt.search_cursor(component_k) if fit_ckpt is not None
              else None)
    if cursor is not None:
        lo, hi = float(cursor["lo"]), float(cursor["hi"])
        start_round = int(cursor.get("rounds", 0))
        evals_skipped = int(cursor["evals"])
        hit = bool(cursor.get("done", False))
        fallbacks = int(cursor.get("fallbacks", 0))
        if cursor.get("best") is not None:
            best = _unpack_batched_best(cursor["best"], cfg, dev)
        if cfg.warm_start and cursor.get("warm_X") is not None:
            warm = (as_tensor(cursor["warm_X"], dev), int(cursor["warm_t"]))
        metrics.counter("fit.resume.evals_skipped").inc(evals_skipped)

    for rd in range(start_round, rounds):
        if hit:
            break
        wd = _solve_watchdog(cfg)
        lams = np.geomspace(lo, hi, B + 2)[1:-1]
        sizes = [
            min(_support_at(v, la, cfg.max_reduced, _buckets_of(cfg)).size,
                feat_perm.size)
            for la in lams
        ]
        X0s = None
        if cfg.warm_start and warm is not None:
            Xw, tw = warm
            X0s = []
            for t in sizes:
                m = min(t, tw)
                X0 = torch.eye(t, dtype=dtype, device=dev)
                X0[:m, :m] = Xw[:m, :m]
                X0s.append(X0)
            warm_starts += len(sizes)
        Sigmas = [Sigma_perm[:t, :t] for t in sizes]
        with trace.span("solver.batched_round", evals=len(sizes),
                        lam_lo=float(lo), lam_hi=float(hi)):
            solved = bcd.solve_bcd_many(
                Sigmas, lams, X0s=X0s,
                betas=None if cfg.beta is None else [cfg.beta] * len(sizes),
                max_sweeps=cfg.max_sweeps, qp_sweeps=cfg.qp_sweeps,
                tol=cfg.tol, tau_iters=cfg.tau_iters,
                impl=_batched_impl(cfg.solver_impl),
            )
        if cfg.solver_fallback:
            solved, fb = bcd.supervise_many(
                solved, Sigmas, lams, X0s=X0s,
                max_sweeps=cfg.max_sweeps, qp_sweeps=cfg.qp_sweeps,
                tol=cfg.tol, tau_iters=cfg.tau_iters,
                debris_dir=_debris_dir(cfg),
            )
            fallbacks += fb
        launches += 1
        evals += len(solved)
        cards = []
        for la, t, S, res in zip(lams, sizes, Sigmas, solved):
            sweeps_i = int(res.sweeps)
            total_sweeps += sweeps_i
            metrics.histogram("solver.sweeps").observe(sweeps_i)
            if not cfg.solver_fallback:
                bcd.observe_result_health(res, max_sweeps=cfg.max_sweeps)
            x_red = bcd.leading_sparse_component(
                res.Z, rel_tol=cfg.support_rel_tol)
            card = int(torch.count_nonzero(x_red))
            cards.append(card)
            cand = {
                "lam": float(la), "t": int(t), "res": res, "x_red": x_red,
                "cardinality": card, "variance": float(x_red @ S @ x_red),
            }
            if better(cand, best):
                best = cand
        if cfg.warm_start:
            warm = (best["res"].X, best["t"])
        hit = (target_card <= best["cardinality"]
               <= target_card + cfg.card_slack)
        if not hit:
            # Tighten the bracket from the whole round at once.
            too_dense = [la for la, c in zip(lams, cards)
                         if c > target_card + cfg.card_slack]
            too_sparse = [la for la, c in zip(lams, cards) if c < target_card]
            new_lo = max(too_dense) if too_dense else lo
            new_hi = min(too_sparse) if too_sparse else hi
            if new_lo >= new_hi:
                hit = True        # bracket collapsed: no finer lambda left
            else:
                lo, hi = float(new_lo), float(new_hi)
        if fit_ckpt is not None:
            # before the watchdog can raise: a deadline kill resumes too
            fit_ckpt.record_search({
                "k": int(component_k), "rounds": rd + 1,
                "evals": evals_skipped + evals,
                "lo": float(lo), "hi": float(hi), "done": bool(hit),
                "fallbacks": int(fallbacks),
                "best": _pack_batched_best(best),
                "warm_X": None if warm is None else to_host(warm[0]),
                "warm_t": None if warm is None else int(warm[1]),
            })
        if wd is not None:
            wd.check()

    assert best is not None
    t = best["t"]
    res = best["res"]
    Sigma_b = Sigma_perm[:t, :t]
    gap = float(validate.kkt_gap(res.X, Sigma_b, best["lam"], res.beta)[0])
    x = np.zeros(n_features)
    x[feat_perm[:t]] = best["x_red"].cpu().numpy()
    nz = np.flatnonzero(x)
    # Re-express the reduced state in sorted-index order, the sequential
    # path's convention.
    sort_idx = np.argsort(feat_perm[:t])
    metrics.counter("search.evals").inc(evals)
    metrics.counter("search.warm_starts").inc(warm_starts)
    metrics.counter("solver.launches").inc(launches)
    if diagnostics is not None:
        diagnostics.update(
            evals=evals,
            warm_starts=warm_starts,
            total_sweeps=total_sweeps,
            cov_builds=cache.builds - builds0 if cache is not None else 1,
            cov_slices=cache.slices - slices0 if cache is not None else 0,
            solve_launches=launches,
            batched=True,
            evals_skipped=evals_skipped,
            fallbacks=fallbacks,
            mesh_degraded=0,
        )
    return PCResult(
        x=x, support=nz, lam=best["lam"], variance=best["variance"],
        cardinality=best["cardinality"], reduced_n=t, gap=gap,
        sweeps=int(res.sweeps), fallbacks=fallbacks,
        reduced_support=feat_perm[:t][sort_idx],
        X_reduced=_principal(res.X, sort_idx) if keep_reduced else None,
        Sigma_reduced=_principal(Sigma_b, sort_idx) if keep_reduced else None,
    )


def _union_base_support(v: np.ndarray, target_card: int, n_components: int,
                        cfg: SPCAConfig) -> np.ndarray:
    """The maximal support a K-component deflated fit can request — the
    seed of the cross-component covariance cache: a prefix of the global
    variance order of length lo_rank (bucket-rounded) + (K-1)(target +
    slack), extended through any variance ties at the cut.  A search that
    escapes it only costs a rebuild."""
    order = _variance_order(v)
    if order.size == 0:
        return order
    vs = v[order]                      # descending
    removed = max(0, n_components - 1) * (target_card + cfg.card_slack)
    raw = min(_bracket_depth(target_card, order.size) + 1, cfg.max_reduced)
    buckets = _buckets_of(cfg)
    if buckets is not None:
        raw = min(next((int(b) for b in buckets if b >= raw), raw),
                  cfg.max_reduced)
    depth = min(order.size, raw + removed)
    tie_hi = int(np.searchsorted(-vs, -vs[depth - 1], side="right"))
    depth = min(max(depth, tie_hi),
                min(order.size, cfg.max_reduced + removed))
    return np.sort(order[:depth])


def _refine_components_batched(results: list[PCResult], stats,
                               cfg: SPCAConfig, counters: dict | None = None,
                               device=None) -> list[PCResult]:
    """Re-polish all fitted components in ONE batched launch at their
    accepted (lambda, reduced support) pairs, warm-started from each
    search's winning iterate."""
    _, build = stats
    Sigmas = [
        r.Sigma_reduced if r.Sigma_reduced is not None
        else as_tensor(build(r.reduced_support), device)
        for r in results
    ]
    lams = [r.lam for r in results]
    X0s = [r.X_reduced for r in results]
    with trace.span("solver.batched_refine", components=len(results)):
        solved = bcd.solve_bcd_many(
            Sigmas, lams, X0s=X0s,
            betas=None if cfg.beta is None else [cfg.beta] * len(results),
            max_sweeps=cfg.max_sweeps, qp_sweeps=cfg.qp_sweeps, tol=cfg.tol,
            tau_iters=cfg.tau_iters, impl=_batched_impl(cfg.solver_impl),
        )
    if cfg.solver_fallback:
        solved, fb = bcd.supervise_many(
            solved, Sigmas, lams, X0s=X0s, max_sweeps=cfg.max_sweeps,
            qp_sweeps=cfg.qp_sweeps, tol=cfg.tol, tau_iters=cfg.tau_iters,
            debris_dir=_debris_dir(cfg),
        )
        if counters is not None:
            counters["fallbacks"] = counters.get("fallbacks", 0) + fb
    metrics.counter("solver.launches").inc()
    out: list[PCResult] = []
    for r, S, res in zip(results, Sigmas, solved):
        x_red = bcd.leading_sparse_component(res.Z,
                                             rel_tol=cfg.support_rel_tol)
        gap = float(validate.kkt_gap(res.X, S, r.lam, res.beta)[0])
        x = np.zeros(r.x.shape[0])
        x[r.reduced_support] = x_red.cpu().numpy()
        nz = np.flatnonzero(x)
        sweeps_i = int(res.sweeps)
        metrics.histogram("solver.sweeps").observe(sweeps_i)
        if not cfg.solver_fallback:
            bcd.observe_result_health(res, max_sweeps=cfg.max_sweeps)
        out.append(replace(
            r, x=x, support=nz, cardinality=int(nz.size),
            variance=float(x_red @ S @ x_red), gap=gap,
            sweeps=r.sweeps + sweeps_i, X_reduced=None, Sigma_reduced=None,
        ))
    return out


def fit_components(
    data,
    n_components: int,
    target_card: int = 5,
    *,
    is_covariance: bool = False,
    cfg: SPCAConfig | None = None,
    deflation: str = "remove",
    diagnostics: dict | None = None,
    stats=None,
    device=None,
) -> list[PCResult]:
    """Top-k sparse PCs.  deflation='remove' drops selected features from
    the dictionary between components (paper-style disjoint topics);
    'project' applies Hotelling deflation to the covariance.  Runs under a
    ``fit.components`` span (one ``fit.component`` child per round).

    ``data`` is a dense (m, n) matrix or an (n, n) covariance (tensor or
    numpy; numpy goes to ``device``, the card by default), or a
    `sparse.SparseCorpus` store handle (out of core, 'remove' only);
    ``stats`` a precomputed ``(variances, build)`` pair.  The K searches
    share ONE covariance cache seeded on the union support, so the whole
    fit normally costs ONE reduced-Gram build — for a store handle 2
    corpus passes in all (``corpus_passes``: screen + one shared Gram),
    with the per-pass ingest tally under ``ingest``.  With
    ``cfg.batch_deflation`` the K components are re-polished by ONE
    batched launch.  ``diagnostics`` collects the per-component search
    counters and the launch/build totals (the reference's keys)."""
    with trace.span("fit.components", n_components=n_components,
                    target_card=target_card, deflation=deflation):
        return _fit_components(
            data, n_components, target_card, is_covariance=is_covariance,
            cfg=cfg, deflation=deflation, diagnostics=diagnostics,
            stats=stats, device=device,
        )


def _fit_components(data, n_components, target_card, *, is_covariance, cfg,
                    deflation, diagnostics, stats, device):
    if cfg is None:
        cfg = SPCAConfig()
    check_config(cfg)
    if device is None and isinstance(data, torch.Tensor):
        device = data.device      # restored components join the data there
    if deflation == "project" and hasattr(data, "iter_chunks"):
        raise ValueError(
            "deflation='project' requires a dense (n, n) covariance; "
            "use deflation='remove' with a SparseCorpus store")
    per_comp: list[dict] = []
    results: list[PCResult] = []
    if deflation == "remove":
        # ``stats`` given (a launcher that streamed the screen itself)
        # skips the screen pass; the caller's counters keep the tally
        ingest: dict = {}
        if stats is None:
            stats = _as_stats(data, is_covariance, cfg.center, device, cfg,
                              counters=ingest)
        mask = np.ones(stats[0].shape[0], dtype=bool)
        # Whole-fit checkpoints (core/fitstate.py): completed components
        # are restored BEFORE any covariance work, so a fully restored fit
        # never seeds the cache (out of core: zero Gram passes).
        fit_ckpt = None
        restored: list[PCResult] = []
        if cfg.resume_dir:
            from . import fitstate

            fit_ckpt = fitstate.FitCheckpointer(
                cfg.resume_dir, every=cfg.fit_checkpoint_every)
            fstate = fit_ckpt.open(fitstate.fit_fingerprint(
                stats[0], n_components=n_components, target_card=target_card,
                deflation=deflation, cfg=cfg))
            restored = [_unpack_pc(p, device)
                        for p in fstate.components[:n_components]]
            for r in restored:
                results.append(r)
                mask[r.support] = False
                per_comp.append({
                    "restored": True, "evals": 0, "warm_starts": 0,
                    "total_sweeps": 0, "cov_builds": 0, "cov_slices": 0,
                    "solve_launches": 0, "evals_skipped": 0,
                    "fallbacks": 0, "batched": cfg.batch_evals > 1,
                })
        cache: ReducedCovarianceCache | None = None
        if cfg.reuse_covariance and len(results) < n_components:
            # One eager build on the union support serves every search
            # below via principal-submatrix slices.
            cache = ReducedCovarianceCache(stats[1], device)
            base = _union_base_support(stats[0], target_card, n_components,
                                       cfg)
            if base.size:
                cache.get(base)
        for k in range(len(results), n_components):
            d: dict = {}
            with trace.span("fit.component", k=k):
                try:
                    r = search_lambda(
                        data, target_card, is_covariance=is_covariance,
                        cfg=cfg, active_mask=mask, stats=stats,
                        diagnostics=d, keep_reduced=cfg.batch_deflation,
                        cov_cache=cache, device=device, fit_ckpt=fit_ckpt,
                        component_k=k,
                    )
                except bcd.SolverDivergenceError as e:
                    e.completed = tuple(results)
                    raise
            per_comp.append(d)
            results.append(r)
            mask[r.support] = False
            if fit_ckpt is not None:
                fit_ckpt.record_component(_pack_pc(r))
        if fit_ckpt is not None:
            fit_ckpt.finish()
        refine_launches = 0
        refine_ctr: dict = {}
        if cfg.batch_deflation and results:
            results = _refine_components_batched(results, stats, cfg,
                                                 counters=refine_ctr,
                                                 device=device)
            refine_launches = 1
        if diagnostics is not None:
            total_fallbacks = (sum(d.get("fallbacks", 0) for d in per_comp)
                               + refine_ctr.get("fallbacks", 0))
            diagnostics.update(
                components=per_comp,
                refine_launches=refine_launches,
                solve_launches=refine_launches + sum(
                    d.get("solve_launches", 0) for d in per_comp),
                cov_builds=cache.builds if cache is not None else sum(
                    d.get("cov_builds", 0) for d in per_comp),
                cov_slices=cache.slices if cache is not None else 0,
                solver_fallbacks=total_fallbacks,
                mesh_degraded=0,
                fit_resume={
                    "components_restored": len(restored),
                    "evals_skipped": sum(
                        d.get("evals_skipped", 0) for d in per_comp),
                    "fallbacks": total_fallbacks, "mesh_degraded": 0,
                },
            )
            if ingest:
                diagnostics.update(
                    ingest=dict(ingest),
                    corpus_passes=ingest.get("screen_passes", 0)
                    + ingest.get("gram_passes", 0),
                    resumed_megabatches=ingest.get("resumed_megabatches", 0),
                )
    elif deflation == "project":
        if stats is not None:
            raise ValueError(
                "stats= is only usable with deflation='remove': Hotelling "
                "deflation mutates the full (n, n) covariance, which a "
                "(variances, build) pair cannot express"
            )
        if not is_covariance:
            A = as_tensor(data, device)
            if cfg.center:
                A = A - A.mean(dim=0, keepdim=True)
            Sigma = (A.T @ A) / A.shape[0]
        else:
            Sigma = as_tensor(data, device).clone()
        for k in range(n_components):
            with trace.span("fit.component", k=k):
                r = search_lambda(Sigma, target_card, is_covariance=True,
                                  cfg=cfg)
            results.append(r)
            x = torch.as_tensor(r.x / max(np.linalg.norm(r.x), 1e-30),
                                dtype=Sigma.dtype, device=Sigma.device)
            P = torch.eye(Sigma.shape[0], dtype=Sigma.dtype,
                          device=Sigma.device) - torch.outer(x, x)
            Sigma = P @ Sigma @ P
    else:
        raise ValueError(f"unknown deflation {deflation!r}")
    return results
