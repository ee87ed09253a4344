#!/usr/bin/env python3
"""What each phase of the SSD-scan kernel costs on one CUDA card.

    python3 tools/ssd_phases.py

Run from the root of a checkout. Builds ``csrc/ssd_scan.cu`` several times,
each with one phase compiled out (its results are then wrong: these builds
are for timing only), into ``build/ssd_phases/``, all ``nvcc`` runs at once,
and times each build's own device time from ``torch.profiler``
(``chip_smoke.kernel_us``) at mamba2-1.3b's 64-token bucket, x (1, 64, 64,
64), B/C (1, 64, 1, 128), chunk 64, and at (1, 256, 64, 64) with chunk 128.
A phase's cost is the full kernel's time less the time without it; "all"
leaves the launch, the staging, seg and the barriers. The phases:

- ``cb``: this block's causal tiles of C.B^T and their stores into the
  cluster;
- ``att``: C.B^T turned into att in place;
- ``y``: att.x and C.S_prev^T, and the y stores;
- ``xw``: x * w split into its TF32 planes;
- ``state``: the state update.

Prints one JSON line per build, with the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "ssd_phases")
SHAPES = [(1, 64, 64, 64, 1, 128, 64), (1, 256, 64, 64, 1, 128, 128)]
# each phase: the first and the last line of its code in csrc/ssd_scan.cu
PHASES = {
    "cb": ("    for (int t = rank + ncl * warp; t < ncb; t += ncl * NW) {",
           "        store_async8(o + 8 * lda, &bars[2], rk, v[2], v[3]);\n"
           "      }\n    }\n"),
    "att": ("    {\n      const int j = tid & (cp - 1), rstep = NT / cp;",
            "        if (j < 16 * ((i >> 4) + 1) && j < 8 * qmax) *v = j <= i "
            "? att : 0.f;\n      }\n    }\n"),
    "y": ("    for (int t = warp; t < (cp / 16) * nyp; t += NW) {",
          "            if (pc + 1 < P) o[1] = v1;\n          }\n        }\n"
          "      }\n    }\n"),
    "xw": ("    {\n      const int lg = __ffs(PS) - 1;",
           "        xwl[j * ldx + p] = __uint_as_float(lo);\n      }\n    }\n"),
    "state": ("    for (int t = warp; t < nmp * npair; t += NW) {",
              "                          decay * s1.y + (big[m][u][3] + "
              "small[m][u][3]));\n        }\n      }\n    }\n"),
}
BUILDS = ["none", *PHASES, "all"]


def cut(src: str, build: str) -> str:
    """The source with the phase(s) of ``build`` compiled out."""
    for name, (first, last) in PHASES.items():
        if build not in (name, "all"):
            continue
        i = src.index(first)
        j = src.index(last, i) + len(last)
        src = src[:i] + "#if 0\n" + src[i:j] + "#endif\n" + src[j:]
    if build in ("cb", "all"):              # no tiles arrive from the others
        src = src.replace("  const uint32_t cb_bytes =\n",
                          "  const uint32_t cb_bytes = 0 *\n", 1)
    return src


def tree(build: str) -> str:
    return os.path.join(OUT, build)


def main() -> None:
    if len(sys.argv) == 3:                # one build, in its own process
        return run(*sys.argv[1:])
    shutil.rmtree(OUT, ignore_errors=True)
    src = open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                            "ssd_scan.cu")).read()
    for b in BUILDS:
        shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                        os.path.join(tree(b), "src", "repro_torch"))
        with open(os.path.join(tree(b), "src", "repro_torch", "csrc",
                               "ssd_scan.cu"), "w") as f:
            f.write(cut(src, b))
    builds = [subprocess.Popen([sys.executable, __file__, "build", b])
              for b in BUILDS]
    if any(p.wait() for p in builds):
        sys.exit("ssd_phases: a build failed")
    for b in BUILDS:
        out = subprocess.run([sys.executable, __file__, "time", b],
                             capture_output=True, text=True, timeout=300)
        if out.returncode:
            sys.exit(f"ssd_phases: {b}: {out.stderr[-2000:]}")
        print(out.stdout.strip(), flush=True)


def run(mode: str, build: str) -> None:
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(tree(build), "kernels")
    sys.path.insert(0, os.path.join(tree(build), "src"))
    sys.path.insert(0, ROOT)
    from repro_torch.kernels import _build
    _build.build_all(["ssd_scan"])
    if mode == "build":
        return
    import torch
    from chip_smoke import card_line, kernel_us, ssd_inputs
    from repro_torch.kernels import ssd
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    us = {}
    for (b, s, h, p, g, n, c) in SHAPES:
        args = ssd_inputs(torch, gen, b, s, h, p, g, n, mamba2_decay=True)
        us[f"({b}, {s}, {h}, {p}) chunk {c}"] = kernel_us(
            torch, lambda: ssd.ssd_scan(*args, chunk=c), 50, ("ssd_scan",))
    print(json.dumps(dict(without=build, kernel_us=us, card=card_line())))


if __name__ == "__main__":
    main()
