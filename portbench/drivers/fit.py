"""Whole sparse-PCA fits back to back on one in-memory corpus.

The corpus is the configuration's own, drawn from its ``seed``; the
run's seed orders its documents, so every seed brings the same work
(`control` can draw a corpus from each seed instead).
A fit is what the dense launcher runs: `spca_run.dense_stats` (the host
variance screen and the reduced-Gram builder) and then
`core.fit_components` with the configuration's solver settings and the
mix's ``batch_evals`` (0: the sequential lambda search, one K1 launch an
evaluation; B > 1: one batched launch of B evaluations a round).  The
window runs fits until ``seconds`` have passed; ``fit_s`` is the
window's seconds, first start to last end, over the fits it completed.

The check compares every fit of the window with the plain reference
(`reference.spca`), which works out again from the corpus: the variance
screen of every word, each component's reduced support at its lambda
(Thm 2.1 with the size guard and the buckets), every Gram the fit built,
and each component: its lambda search tried the lambdas of the geometric
bisection from the bracket the reference's screen gives, stopped where
that bisection stops (a cardinality in ``target_card`` to ``target_card +
card_slack``, or ``lam_search_evals`` tries) and kept the best try (the
cardinalities of the tries are the program's: the check follows its
search); its words are ones Thm 2.1 keeps and no earlier component took,
its reported variance is x' Sigma x, and its DSPCA value
x' Sigma x - lam |x|_1^2 falls short of the reference's converged
solution at that lambda by no more than the limit.  The search check is
the sequential search's; a mix with ``batch_evals`` above 1 leaves it
out.
"""
from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from portbench import gen, harness
from portbench.reference import spca as ref


@dataclass
class Fit:
    t0: float
    t1: float           # screen done
    t2: float           # fit done
    variances: np.ndarray
    grams: list         # (support, program's Gram) of every build
    results: list       # PCResult of each component
    diag: dict
    searches: list      # (lambda, cardinality, variance) of each solve,
                        # one list a component


class Run:
    def __init__(self, cell, *, seed: int, device, fault=None):
        self.cell, self.seed, self.device, self.fault = cell, seed, device, fault
        self.law = cell.config["corpus"]
        self.fitcfg = cell.config["fit"]
        self.fits: list[Fit] = []
        self.attempted = self.failed = 0

    # ------------------------------------------------------------- set-up
    def setup(self):
        from repro_torch.core import SPCAConfig
        from repro_torch.data.corpus import Corpus

        # the configuration's one corpus, its documents in the seed's order
        self.bag = gen.reorder_docs(
            gen.bag(self.law, int(self.law["n_docs"]), int(self.law["seed"]),
                    0, self.device), self.seed, self.device)
        b = self.bag
        self.corpus = Corpus(
            n_docs=b.n_docs, vocab=[f"w{i:06d}" for i in range(b.n_words)],
            doc_idx=b.doc_idx, word_idx=b.word_idx, counts=b.counts,
            topics=dict(b.topics))
        # the launcher's setting: the Gram is a full-float32 product
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        f = self.fitcfg
        self.cfg = SPCAConfig(
            max_sweeps=int(f["max_sweeps"]),
            lam_search_evals=int(f["lam_search_evals"]),
            card_slack=int(f["card_slack"]),
            max_reduced=int(f["max_reduced"]),
            support_buckets=tuple(int(b) for b in f["support_buckets"]),
            support_rel_tol=float(f["support_rel_tol"]),
            batch_evals=int(self.cell.traffic["batch_evals"]))
        self._record_searches()
        if self.fault:
            FAULTS[self.fault](self)

    def _record_searches(self):
        """Record each lambda search's solves as the program returns them
        (a list a search), for the check to follow the bisection."""
        from repro_torch.core import spca

        search, solve = spca.search_lambda, spca.solve_at_lambda
        self._searches: list = []

        def search_lambda(*a, **kw):
            self._searches.append([])
            return search(*a, **kw)

        def solve_at_lambda(data, lam, **kw):
            r = solve(data, lam, **kw)
            self._searches[-1].append(
                (float(lam), int(r.cardinality), float(r.variance)))
            return r

        spca.search_lambda, spca.solve_at_lambda = search_lambda, \
            solve_at_lambda

    def fit_once(self, trace: bool) -> Fit:
        from repro_torch.core import fit_components
        from repro_torch.launch import spca_run

        self._searches = []
        t0 = time.perf_counter()
        with harness.annotate("portbench.screen", trace):
            var, build = spca_run.dense_stats(self.corpus, self.device)
        t1 = time.perf_counter()
        grams = []

        def recorded(support):
            out = build(support)
            grams.append((np.array(support), out))
            return out

        diag: dict = {}
        with harness.annotate("portbench.fit", trace):
            results = fit_components(
                None, int(self.fitcfg["components"]),
                target_card=int(self.fitcfg["target_card"]), cfg=self.cfg,
                stats=(var, recorded), diagnostics=diag, device=self.device)
        return Fit(t0, t1, time.perf_counter(), np.asarray(var), grams,
                   results, diag, self._searches)

    def warm(self, trace: bool):
        self.fit_once(trace)

    # ------------------------------------------------------------- window
    def window(self, seconds: float, trace: bool) -> dict:
        end = time.perf_counter() + seconds
        while True:
            self.attempted += 1
            try:
                self.fits.append(self.fit_once(trace))
            except Exception as e:   # a fit that raises gives no answer
                self.failed += 1
                print(f"portbench: a fit raised {type(e).__name__}: {e}",
                      file=sys.stderr, flush=True)
                break
            if time.perf_counter() >= end:
                break
        if not self.fits:
            return {"fit_s": math.inf}
        print("portbench: each fit's screen and fit seconds: " + ", ".join(
            f"{f.t1 - f.t0:.3f}+{f.t2 - f.t1:.3f}" for f in self.fits),
            file=sys.stderr, flush=True)
        span = self.fits[-1].t2 - self.fits[0].t0
        return {"fit_s": span / len(self.fits)}

    def release(self):
        """Free the program's device state before the reference runs:
        every Gram goes to the host."""
        for f in self.fits:
            f.grams = [(s, g.detach().cpu().numpy()) for s, g in f.grams]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def check(self) -> dict:
        b, fc, lim = self.bag, self.fitcfg, self.cell.limits
        _, v_ref = ref.column_moments(b.n_docs, b.n_words, b.word_idx,
                                      b.counts)
        cols = ref.columns(b.n_docs, b.n_words, b.doc_idx, b.word_idx,
                           b.counts)
        grams: dict = {}

        def gram(support):
            key = tuple(np.asarray(support).tolist())
            if key not in grams:
                grams[key] = ref.centred_gram(cols, support)
            return grams[key]

        solved: dict = {}
        out = dict(failed_fits=float(self.failed), screen_rel=0.0,
                   support_miss=0.0, gram_rel=0.0, search_off=0.0,
                   unsafe_words=0.0, var_rel=0.0, dspca_shortfall=0.0)
        vmax = float(v_ref.max())
        target, slack = int(fc["target_card"]), int(fc["card_slack"])
        batched = int(self.cell.traffic["batch_evals"]) > 1
        for f in self.fits:
            out["screen_rel"] = max(out["screen_rel"], float(
                np.abs(f.variances - v_ref).max()) / vmax)
            for support, G in f.grams:
                R = gram(support)
                out["gram_rel"] = max(out["gram_rel"], float(
                    np.abs(G - R).max() / np.abs(np.diagonal(R)).max()))
            mask = np.ones(b.n_words, bool)
            for k, r in enumerate(f.results):
                evals = f.searches[k] if k < len(f.searches) else []
                if not batched and not ref.search_is_bisection(
                        ref.search_bracket(v_ref, mask, target), evals,
                        target, slack, int(fc["lam_search_evals"]), r.lam):
                    out["search_off"] += 1
                keep = ref.screened_support(v_ref, r.lam, mask,
                                            int(fc["max_reduced"]),
                                            fc["support_buckets"])
                if not np.array_equal(keep, np.asarray(r.reduced_support)):
                    out["support_miss"] += 1
                safe = mask & (v_ref >= r.lam)
                words = np.asarray(r.support)
                out["unsafe_words"] += float(np.count_nonzero(~safe[words]))
                x = np.asarray(r.x, np.float64)[words]
                S = gram(words)
                xsx = float(x @ S @ x)
                out["var_rel"] = max(out["var_rel"],
                                     abs(r.variance - xsx) / xsx)
                key = (r.lam, tuple(keep.tolist()))
                if key not in solved:
                    Sk = gram(keep)
                    xr = ref.leading_component(ref.solve_dspca(Sk, r.lam),
                                               float(fc["support_rel_tol"]))
                    solved[key] = float(xr @ Sk @ xr
                                        - r.lam * np.abs(xr).sum() ** 2)
                best = solved[key]
                mine = xsx - r.lam * np.abs(x).sum() ** 2
                out["dspca_shortfall"] = max(out["dspca_shortfall"],
                                             (best - mine) / abs(best))
                mask[words] = False
        if batched:
            del out["search_off"]
        return {k: (float(v), float(lim[k])) for k, v in out.items()}


# ------------------------------------------------------------------ faults
# Each plants one fault under the timed path; the check must then fail.

def _state_unchanged(run):
    """Every solve returns the state it started from."""
    from repro_torch.core import bcd

    solve, many = bcd.solve_bcd, bcd.solve_bcd_many

    def unchanged(res, X0):
        X = X0.to(res.X.dtype)
        return res._replace(X=X, Z=X / torch.trace(X))

    def solve_bcd(Sigma, lam, **kw):
        res = solve(Sigma, lam, **kw)
        X0 = kw.get("X0")
        if X0 is None:
            X0 = torch.eye(Sigma.shape[0], dtype=Sigma.dtype,
                           device=Sigma.device)
        return unchanged(res, X0)

    def solve_bcd_many(Sigmas, lams, **kw):
        out = many(Sigmas, lams, **kw)
        X0s = kw.get("X0s") or [None] * len(out)
        return [unchanged(r, X0 if X0 is not None else torch.eye(
            S.shape[0], dtype=S.dtype, device=S.device))
            for r, S, X0 in zip(out, Sigmas, X0s)]

    bcd.solve_bcd, bcd.solve_bcd_many = solve_bcd, solve_bcd_many


def _half_batch(run):
    """The screen and the Gram see the first half of the documents."""
    from repro_torch.data.corpus import Corpus

    c = run.corpus
    half = c.n_docs // 2
    keep = c.doc_idx < half
    run.corpus = Corpus(n_docs=half, vocab=c.vocab, doc_idx=c.doc_idx[keep],
                        word_idx=c.word_idx[keep], counts=c.counts[keep],
                        topics=c.topics)


def _answer_altered(run):
    """The first component's largest loading moves to another word."""
    import repro_torch.core as core
    from dataclasses import replace

    fit = core.fit_components

    def fit_components(*a, **kw):
        out = fit(*a, **kw)
        r = out[0]
        x = np.array(r.x)
        i = int(np.argmax(np.abs(x)))
        j = int(np.flatnonzero(x == 0)[0])
        x[j], x[i] = x[i], 0.0
        out[0] = replace(r, x=x, support=np.flatnonzero(x))
        return out

    core.fit_components = fit_components


def _search_stopped(run):
    """The lambda search stops after its first evaluation."""
    from dataclasses import replace

    run.cfg = replace(run.cfg, lam_search_evals=1)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered, "search_stopped": _search_stopped}
