#!/usr/bin/env python3
"""Time the three collective-matmul kernels of one tree of the port on one
H100 (rows 12-16 of ``PERF.md``'s kernel table): ``agmm_kernel``,
``mmrs_kernel`` and ``wgrad_kernel``.

Run from the repository root: ``python3 tools/cmatmul_turns.py [--tree
DIR] [--label NAME]``. ``DIR`` (default: this repository) is the root of
the checkout whose ``accl_tpu_torch`` is measured, for instance an older
commit unpacked with ``git archive``, so that two trees are compared in one
call on one card (run parent, change, change, parent). Only the wrappers'
stable API is called (``agmm``, ``mmrs``, ``wgrad``, their plain versions
and the plans), through ``chip_smoke.cmatmul_turns`` of this repository.

Figures, all f32 at world 8, each call's launches timed together in turns
with its plain version and its library call (``chip_smoke.time_in_turns``,
the host's launch work hidden), each result first held within
``chip_smoke.f32_sum_bound`` of the plain version's:

* the main-path shapes of phases 3f and 3g at Megatron-LM 8.3B's width:
  agmm x (8, 256, 3072) by w1 (8, 3072, 1536), one launch; mmrs h (8, 2048,
  1536) by w2 (8, 1536, 3072), two launches; wgrad x (8, 256, 3072)
  travelling against dy (8, 2048, 1536), four launches;
* the lane shape (256, 512, 512), the resident plans (rows 12 and 13).

Prints one JSON object (label, tree, card line, figures) as its last line;
exits 2 without a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke():
    """This repository's ``chip_smoke`` module, whichever tree is measured."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("cmatmul_turns: no CUDA device visible", file=sys.stderr)
        return 2
    cs = smoke()
    sys.path.insert(0, os.path.abspath(args.tree))
    import accl_tpu_torch
    pkg = os.path.dirname(os.path.abspath(accl_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(args.tree):
        cs.fail(f"imported accl_tpu_torch from {pkg}, not from {args.tree}")
    card = cs.card_line()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    res = {"label": args.label, "tree": os.path.abspath(args.tree),
           "card": card}
    P = cs.MEGATRON["tp"]
    main_shape = (cs.MEGATRON["tokens"] // P, cs.MEGATRON["d"],
                  cs.MEGATRON["h"] // P)
    for what, shape, iters in (("main path", main_shape, 7),
                               ("lane", cs.CMATMUL_LANE, 30)):
        for name, r in cs.cmatmul_turns(gen, shape, iters).items():
            key = f"{name} {what}"
            res[key] = {k: r[k] for k in ("shape", "plan", "ms", "plain_ms",
                                          "library_ms", "max_abs_err")}
            cs.log(f"{args.label}: {key} {r['shape']} ({r['plan']}): kernel "
                   f"{r['ms']!r} ms, plain {r['plain_ms']!r} ms, library "
                   f"{r['library_ms']!r} ms, max_abs_err "
                   f"{r['max_abs_err']!r}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
