"""Compare two checkouts of the port on one NVIDIA GPU, in turns.

    python3 chip_turns.py OTHER_CHECKOUT
    python3 chip_turns.py OTHER_CHECKOUT --packed

OTHER_CHECKOUT is a second tree of this repository (a ``git archive`` of
another commit unpacked under ``build/``, which git ignores). The script

  1. runs each tree's ``chip_smoke.py --only kernels`` in turns (other,
     this, this, other), each in its own process that builds into its
     own tree's ``build/``, and lists every kernel's time from each run;
  2. compares the machine code (``cuobjdump -sass``) of the two trees'
     libraries function by function: equal, different, or in one only;
  3. runs each tree's kernel-phase checks once more in a process that
     records the output of every call of a launch-counted wrapper, the
     global generators seeded before each phase, and compares the two
     records call by call with ``torch.equal`` (the first calls of each
     wrapper, as many as both trees made).

With ``--packed`` it does none of that, and instead times, in turns
(other, this, this, other, each in its own process), the four kernels a
packed decode step launches (fused_loki_decode,
block_sparse_attention_grouped, paged_full_decode,
fused_exact_topk_decode) at llama2-7b's decode shape (Hkv 32, D 128, S
4096, bs 128, d 32, k_blocks 8, bf16 queries over a paged fp32 pool,
128-token pages) at B 1, 2 and 4, as a 4-slot engine's packed steps
launch them: a tree whose wrappers take ``plan_rows`` plans every step
for the engine's 4 x 32 rows, an older tree for the step's own B x 32.
Each time is chip_smoke's ``time_ms`` (CUDA events, L2 flushed, median of
20). Results go to ``chiprun_out/turns/packed.json``.

Everything goes to ``chiprun_out/turns/``: each run's chip_smoke.json and
log, the SASS summary and the comparison (``summary.json``). Imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "turns")

# Run in a tree's own process: that tree's kernel-phase checks with every
# launch-counted wrapper's outputs recorded (moved to the host) in order.
RECORD = r"""
import sys
import torch
root, path = sys.argv[1], sys.argv[2]
sys.path[:0] = [root, root + "/src"]
import chip_smoke as C
import repro_torch.kernels as K
from repro_torch.kernels import (approx_scores, approx_scores_fm,
                                 flash_attention, fused_decode,
                                 gather_attention)
rec = {}

def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (tuple, list)):
        return type(x)(host(y) for y in x)
    return x

def recorded(fn):
    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        rec.setdefault(fn.__name__, []).append(host(out))
        return out
    call.launches = 0     # the wrappers count on their module's name
    return call

for mod in (approx_scores, approx_scores_fm, flash_attention, fused_decode,
            gather_attention):
    for fn in K.KERNELS:
        if getattr(mod, fn.__name__, None) is fn:
            setattr(mod, fn.__name__, recorded(fn))
results = {}
for phase in ("check_kernels", "check_layouts", "check_paged",
              "check_head_kernels", "check_flash"):
    # check_paged fills its pools' trash rows from the global generator,
    # whose state on entry is not the same in two processes
    torch.manual_seed(0)
    getattr(C, phase)(results)
torch.save(rec, path)
"""

# Run in a tree's own process: the packed steps' kernels at B 1, 2, 4 of a
# 4-slot engine, timed with that tree's wrappers; JSON on stdout.
PACKED = r"""
import inspect, json, sys
import torch
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import chip_smoke as C
from repro_torch.kernels import fused_decode as F
from repro_torch.kernels import gather_attention as GA
ENGINE, HKV, PS = 4, 32, 128
takes = "plan_rows" in inspect.signature(F.fused_loki_decode).parameters
n_sm = GA._sm_count(torch.device("cuda"))
out = dict(plan_rows=takes, ms={}, plan={})
for b in (1, 2, 4):
    case = C.make_case(f"B={b}", B=b, Hkv=HKV, G=1, D=128, S=4096, bs=128,
                       d=32, kb=8, lw=16, sw=0,
                       cur=[3000, 2500, 1800, 3100][:b],
                       kv_dtype=torch.float32, q_dtype=torch.bfloat16,
                       seed=40 + b)
    q, cur, table, pk, pv, _, _ = C.paged_copy(case, PS, seed=b)
    q, cur, table = q[:b], cur[:b], table[:b]      # no idle row
    pg = dict(page_table=table, page_size=PS)
    rows = ENGINE * HKV if takes else b * HKV
    ex = dict(plan_rows=rows) if takes else {}
    kw, ex_kw = C.kernel_kw(case), C.kernel_kw(case, exact=True)
    att = dict(block_size=128, scale=kw["scale"], sliding_window=0)
    sel = F.select_blocks(q, pk, cur, **kw, **pg)
    calls = {
        "fused_loki_decode": lambda: F.fused_loki_decode(
            q, pk, pv, cur, **kw, **pg, **ex),
        "block_sparse_attention_grouped": lambda:
            GA.block_sparse_attention_grouped(q, pk, pv, sel, cur, **att,
                                              **pg, **ex),
        "paged_full_decode": lambda: GA.paged_full_decode(
            q, pk, pv, cur, **att, **pg, **ex),
        "fused_exact_topk_decode": lambda: F.fused_exact_topk_decode(
            q, pk, pv, cur, **ex_kw, **pg, **ex),
    }
    for name, fn in calls.items():
        out["ms"][f"{name} B={b}"] = C.time_ms(fn)
    out["plan"][f"B={b}"] = dict(
        rows=rows, C=GA.fused_cluster_size(4096 // 128, rows, n_sm),
        n_split=GA.full_decode_n_split(4096 // 128, rows, n_sm))
    del pk, pv
print(json.dumps(out))
"""


def run_packed(tree: str, label: str, turn: int) -> dict:
    """One ``PACKED`` timing of ``tree`` in its own process."""
    proc = subprocess.run([sys.executable, "-c", PACKED, tree], cwd=tree,
                          capture_output=True, text=True, timeout=1500)
    with open(os.path.join(OUT, f"packed_{turn}_{label}.log"), "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"packed {turn} {label} failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"packed turn {turn} {label} (plan_rows {got['plan_rows']}, "
          f"plans {got['plan']}): "
          + ", ".join(f"{n} {t:.4f}" for n, t in got["ms"].items()),
          flush=True)
    return got


# Run in a tree's own process: its built libraries' paths, as JSON.
LIBS = r"""
import json, sys
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch.kernels import _build
print(json.dumps({n: str(_build.lib_path(n)) for n in _build.LIBRARIES}))
"""


def run_smoke(tree: str, label: str, turn: int) -> dict:
    """One ``chip_smoke.py --only kernels`` of ``tree``; its kernels' ms."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--only",
                           "kernels"], cwd=tree, capture_output=True,
                          text=True, timeout=1500)
    secs = time.perf_counter() - t0
    tag = f"{turn}_{label}"
    with open(os.path.join(OUT, f"{tag}.log"), "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{tag}: chip_smoke.py failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    src = os.path.join(tree, "chiprun_out", "chip_smoke.json")
    shutil.copy(src, os.path.join(OUT, f"{tag}.json"))
    with open(src) as fh:
        kernels = json.load(fh)["kernels"]
    ms = {k["name"]: k["ms"] for k in kernels}
    print(f"turn {turn} {label} ({secs:.1f} s): "
          + ", ".join(f"{n} {t:.4f}" for n, t in ms.items()
                      if "[" not in n), flush=True)
    return ms


def sass_functions(lib: str) -> dict:
    """``cuobjdump -sass`` of a library, as {function name: its code}, runs
    of blanks made one (cuobjdump pads its comment column to the widest
    instruction in the whole library)."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", re.sub(r"[ \t]+", " ",
                                                         text))
    return dict(zip(parts[1::2], parts[2::2]))


def compare_sass(other: str) -> dict:
    libs = {}
    for tree in (other, ROOT):
        out = subprocess.run([sys.executable, "-c", LIBS, tree],
                             capture_output=True, text=True, check=True)
        libs[tree] = json.loads(out.stdout)
    summary = {}
    for name, path in libs[ROOT].items():
        mine = sass_functions(path)
        theirs = sass_functions(libs[other][name])
        same = sorted(f for f in mine if theirs.get(f) == mine[f])
        summary[name] = dict(
            equal=len(same),
            different=sorted(f for f in mine
                             if f in theirs and theirs[f] != mine[f]),
            only_here=sorted(set(mine) - set(theirs)),
            only_other=sorted(set(theirs) - set(mine)))
        s = summary[name]
        if s["different"]:
            with open(os.path.join(OUT, f"sass_{name}.diff"), "w") as fh:
                for f in s["different"]:
                    fh.writelines(difflib.unified_diff(
                        theirs[f].splitlines(True), mine[f].splitlines(True),
                        f"other {f}", f"this {f}", n=1))
        print(f"sass {name}: {s['equal']} functions equal, "
              f"{len(s['different'])} different {s['different']}, "
              f"{len(s['only_here'])} only here, {len(s['only_other'])} "
              "only in the other tree", flush=True)
    return summary


def compare_outputs(other: str) -> dict:
    import torch
    recs = {}
    for label, tree in (("other", other), ("this", ROOT)):
        path = os.path.join(OUT, f"outputs_{label}.pt")
        proc = subprocess.run([sys.executable, "-c", RECORD, tree, path],
                              cwd=tree, capture_output=True, text=True,
                              timeout=1500)
        if proc.returncode != 0:
            raise RuntimeError(f"recording {label}'s outputs failed "
                               f"({proc.returncode}):\n{proc.stderr[-4000:]}")
        recs[label] = torch.load(path)
        os.remove(path)

    def equal(a, b):
        if isinstance(a, torch.Tensor):
            return isinstance(b, torch.Tensor) and torch.equal(a, b)
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(map(equal, a, b))
        return a == b

    summary = {}
    for name in sorted(set(recs["this"]) | set(recs["other"])):
        mine, theirs = recs["this"].get(name, []), recs["other"].get(name,
                                                                      [])
        n = min(len(mine), len(theirs))
        differ = [i for i in range(n) if not equal(mine[i], theirs[i])]
        summary[name] = dict(compared=n, differ=differ,
                             calls_here=len(mine), calls_other=len(theirs))
        print(f"outputs {name}: {n - len(differ)}/{n} calls bit-equal "
              f"(calls here {len(mine)}, in the other tree {len(theirs)})",
              flush=True)
    return summary


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("--packed", action="store_true",
                    help="time the packed steps' kernels at B 1, 2, 4 in "
                         "turns instead")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    other = os.path.abspath(args.other)
    os.makedirs(OUT, exist_ok=True)
    order = [("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)]
    if args.packed:
        runs = [dict(turn=i, tree=label, **run_packed(tree, label, i))
                for i, (label, tree) in enumerate(order)]
        with open(os.path.join(OUT, "packed.json"), "w") as fh:
            json.dump(runs, fh, indent=1)
        return 0
    times = [dict(turn=i, tree=label, ms=run_smoke(tree, label, i))
             for i, (label, tree) in enumerate(order)]
    summary = dict(times=times, sass=compare_sass(other),
                   outputs=compare_outputs(other))
    with open(os.path.join(OUT, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
