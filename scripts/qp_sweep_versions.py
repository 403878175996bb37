#!/usr/bin/env python3
"""Kernel K7 (``bcd_sweep``) of several checkouts on one card, in turns.

    python3 scripts/qp_sweep_versions.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (``.`` for this one; another
commit unpacked with ``git archive``).  The script makes the inputs once,
then runs each ROOT in its own process, in the order given (so
``parent . . parent`` gives turns), each building that checkout's K7 from
its own sources and calling its ``bcd_sweep.qp_sweep_cuda`` on the same
inputs:

* timing: a row update of Sigma_hat over a generated NYTimes-width
  corpus's (12,000 docs) n highest-variance words, row and column 0
  zeroed, s its column 0, lam a quarter of max |s|, float32, 4 sweeps,
  as ``chip_smoke.py`` ``dense_timing`` times it, at every n the
  per-row fit launches K7 at (``--n``): device ms (the profiler's time
  of the K7 kernel, ``chip_smoke.device_ms``; and of every kernel the
  call launches), ms (CUDA events, back to back) and the host's time a
  call (``host_us``: 200 calls enqueued, no synchronisation);
* bits: (u, w, R2) on row updates of that Sigma_hat and of the identity
  (every dividend zero), j first, middle and last, 4 sweeps, float32 at
  n 9, 33, 48, 97, 192 and 224 and float64 at 33 and 160.

Each run prints one JSON line a timing; the last lines say, for every
ROOT against the first, whether w and R2 are the same bits in every
case and u the same up to the sign of a zero (the cases that are not),
then the card's name and power limit.  Exits non-zero without a card.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_HATS = (24, 32, 48, 64, 96, 128, 192)
HOST_REPS = 200                   # calls whose host time gives host_us
BIT_SIZES = ((4, 9), (4, 33), (4, 48), (4, 97), (4, 192), (4, 224),
             (8, 33), (8, 160))


def _row_update(X, S, j, dtype):
    import numpy as np

    m = np.ones(X.shape[0])
    m[j] = 0.0
    Y = (X * m[:, None] * m[None, :]).astype(dtype)
    s = (S[:, j] * m).astype(dtype)
    return Y, s, 0.25 * float(np.abs(s).max())


def make_inputs(path, n_hats):
    """The timing and bit cases, from this checkout's corpus generator,
    saved to ``path`` (npz): arrays ``<case>_Y``, ``<case>_s`` and a JSON
    index of (case, lam, j, kind)."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.data.corpus import NYTIMES_TOPICS, make_corpus
    from repro_torch.launch.spca_run import dense_stats

    corpus = make_corpus(12_000, 102_660, topics=NYTIMES_TOPICS, seed=0)
    var, build = dense_stats(corpus, torch.device("cuda"))
    order = np.argsort(-var, kind="stable")
    arrays, index = {}, []
    sizes = sorted(set(n_hats) | {n for _, n in BIT_SIZES})
    S = {n: build(np.sort(order[:n])).double().cpu().numpy() for n in sizes}
    for n in n_hats:
        Y, s, lam = _row_update(S[n], S[n], 0, np.float32)
        name = f"time_n{n}"
        arrays[f"{name}_Y"], arrays[f"{name}_s"] = Y, s
        index.append({"case": name, "kind": "time", "n": n, "j": 0,
                      "lam": lam})
    for itemsize, n in BIT_SIZES:
        dtype = np.float32 if itemsize == 4 else np.float64
        for xname, X in (("sigma", S[n]), ("identity", np.eye(n))):
            for j in sorted({0, n // 2, n - 1}):
                Y, s, lam = _row_update(X, S[n], j, dtype)
                name = f"bits_{np.dtype(dtype).name}_n{n}_{xname}_j{j}"
                arrays[f"{name}_Y"], arrays[f"{name}_s"] = Y, s
                index.append({"case": name, "kind": "bits", "n": n, "j": j,
                              "lam": lam})
    np.savez(path, index=np.array(json.dumps(index)), **arrays)


def worker(root, inputs, out):
    """Run ``root``'s K7 on the saved inputs: print a JSON line a timing,
    save every bit case's (u, w, R2) to ``out``."""
    import numpy as np
    import torch

    sys.path[:0] = [os.path.join(os.path.abspath(root), "src"), ROOT]
    import chip_smoke
    from repro_torch.kernels import bcd_sweep

    here = os.path.realpath(bcd_sweep.__file__)
    if not here.startswith(os.path.realpath(root) + os.sep):
        raise SystemExit(f"qp_sweep_versions: {root} gave {here}")
    data = np.load(inputs)
    dev = torch.device("cuda")
    saved = {}
    for case in json.loads(str(data["index"])):
        name = case["case"]
        Y, s = (torch.from_numpy(data[f"{name}_{k}"]).to(dev)
                for k in ("Y", "s"))
        lam, j = case["lam"], case["j"]

        def run():
            return bcd_sweep.qp_sweep_cuda(Y, s, lam, s, j, 4)
        if case["kind"] == "time":
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_REPS):
                run()
            host_us = (time.perf_counter() - t0) / HOST_REPS * 1e6
            row = {"root": root, "n": case["n"], "sweeps": 4,
                   "device_ms": chip_smoke.device_ms(run, kernel="qp_sweep"),
                   "all_kernels_device_ms": chip_smoke.device_ms(run),
                   "ms": chip_smoke.cuda_ms(run, 50), "host_us": host_us}
            print(json.dumps(row), flush=True)
        else:
            u, w, r2 = run()
            torch.cuda.synchronize()
            for k, v in (("u", u), ("w", w), ("R2", r2)):
                saved[f"{name}_{k}"] = v.cpu().numpy()
    np.savez(out, **saved)


def main(argv):
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--n", type=int, nargs="+", default=list(N_HATS))
    ap.add_argument("--worker", nargs=2, metavar=("INPUTS", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("qp_sweep_versions: needs a CUDA card", file=sys.stderr)
        return 1
    if args.worker:
        worker(args.roots[0], *args.worker)
        return 0
    with tempfile.TemporaryDirectory(prefix="qp_sweep_versions_") as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        make_inputs(inputs, args.n)
        outs = []
        for k, root in enumerate(args.roots):
            out = os.path.join(tmp, f"out{k}.npz")
            subprocess.run([sys.executable, os.path.abspath(__file__), root,
                            "--worker", inputs, out], check=True)
            outs.append(dict(np.load(out)))
    first = outs[0]
    for root, got in zip(args.roots[1:], outs[1:]):
        bits, u_zero_sign = [], []
        for key in first:
            name, k = key.rsplit("_", 1)
            a, b = first[key], got[key]
            if k == "u":
                same = np.array_equal(a + 0.0, b + 0.0)
                if not same:
                    u_zero_sign.append(name)
            elif a.tobytes() != b.tobytes():
                bits.append(f"{name}_{k}")
        print(json.dumps({"root": root, "against": args.roots[0],
                          "cases": len(first) // 3,
                          "w_R2_bits_equal": not bits, "differ": bits,
                          "u_equal_up_to_zero_sign": not u_zero_sign,
                          "u_differ": u_zero_sign}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
