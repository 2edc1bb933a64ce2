"""Time variants of the one-block gather kernel on the 1024×256 hole sheet.

The one-block form of ``csrc/ell_gather.cu`` (one thread block an SM, the
window of vector rows in a ``cp.async`` ring, the operator read straight from
device memory) walks each block's run in tiles of ``T`` sites.  This script
separates what sets its pace a tile by timing variants of that source, each
changed in one place, on the sheet ``HoleSheet(1024, 256, 60)`` (N = 250855,
S = 5, relabelled block bandwidth 293) at K = 8, with the operator in
complex64 and in the bf16 form, product and step:

  base        the source as given;
  const_op    (a) the operator's loads replaced by a constant block;
  no_sync     (b) the block-wide barrier a tile removed (the answer may be wrong);
  static_s    (c) the slot loop unrolled over a compile-time S = 5;
  tile64      (d) tiles of 64 sites with the same run (twice the tiles a run);
  threads512  (e) 512 threads, two sites a thread.

Run it on a machine with one NVIDIA card and ``nvcc``, from the repository
root, on the one-block source as it stood before the cluster form (commit
12aa286)::

    git show 12aa286:bodge_tpu_torch/csrc/ell_gather.cu > build/ell_gather_oneblock.cu
    python3 tools/gather_variants.py --source build/ell_gather_oneblock.cu --out chiprun_out/variants.json

``--source`` must be a one-block source with the entry points
``ell_gather_spmm_launch`` / ``ell_gather_cheb_step_launch`` taking
``(..., TK, T, bwb, D, run, ctas, threads, stream)``.  The variants are built
with the package's ``nvcc`` flags into ``build/variants/``, all compilers
started together.  Each kernel is timed by CUDA events over ``--reps``
launches (50), in turns (every kernel, then every kernel in reverse order);
the least of the two is reported, with the card's name and power limit, and
``ell_spmm`` / ``ell_cheb_step`` on the same relabelled operator beside them.
``--package`` adds the package's own gather kernels on their planned layouts
(complex64: the one-block form; bf16: the cluster form), held against the
plain versions and repeated bit for bit, in the same turns; ``--tiles
96:3,128:2`` adds the bf16 cluster form at forced tiles ``T`` and stage
counts.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CONST_HELPER = """
template <typename OP> __device__ __forceinline__ OP const_block();
template <> __device__ __forceinline__ float4 const_block<float4>() { return make_float4(0.25f, 0.f, -0.25f, 0.125f); }
template <> __device__ __forceinline__ uint4 const_block<uint4>() {
  return make_uint4(0x3e803f80u, 0xbe800000u, 0x3e003f00u, 0x00003f80u);
}
"""

LOAD = "for (int e = 0; e < opform::Op<OP>::PER_BLOCK; ++e) d[e] = __ldg(blk + e);"
SYNC = "    __syncthreads();  // ... everyone's; and every thread is done with tile t - 1\n"
LOOP = "#pragma unroll 4\n        for (int s = 0; s < S; ++s) {"
ANCHOR = "template <bool CHEB, int VEC, typename OP>\n__global__"

# name -> (source replacements, plan change)
VARIANTS = {
    "base": ([], None),
    "const_op": ([(ANCHOR, CONST_HELPER + ANCHOR),
                  (LOAD, "for (int e = 0; e < opform::Op<OP>::PER_BLOCK; ++e) d[e] = const_block<OP>(); (void)blk;")],
                 None),
    "no_sync": ([(SYNC, "")], None),
    "static_s": ([(LOOP, "#pragma unroll\n        for (int s = 0; s < 5; ++s) {")], None),
    "tile64": ([], "tile64"),
    "threads512": ([], "threads512"),
}


class HoleSheet:
    """An Lx×Ly open sheet with a circular hole, numbered along x within each
    row of constant y (the sheet of ``chip_smoke.py``'s generic phase), offering
    the vectorised arrays ``skeleton_from_lattice`` reads."""

    def __init__(self, Lx, Ly, radius):
        x, y = np.meshgrid(np.arange(Lx), np.arange(Ly), indexing="ij")
        keep = (x - Lx / 2) ** 2 + (y - Ly / 2) ** 2 > radius**2
        x, y, keep = x.T, y.T, keep.T
        xs, ys = x[keep], y[keep]
        self.shape = (Lx, Ly, 1)
        self.site_coords = np.stack([xs, ys, np.zeros(len(xs), dtype=np.int64)], axis=1)
        self.size = len(xs)
        self._number = np.full((Lx, Ly), -1, dtype=np.int64)
        self._number[xs, ys] = np.arange(self.size)

    def index_array(self, coords):
        coords = np.asarray(coords)
        return self._number[coords[..., 0], coords[..., 1]]

    def bond_arrays(self):
        src, dst = [], []
        for axis in (1, 0):
            hi = self.site_coords.copy()
            hi[:, axis] += 1
            inside = hi[:, axis] < self.shape[axis]
            inside[inside] = self._number[hi[inside, 0], hi[inside, 1]] >= 0
            lo, hi = self.site_coords[inside], hi[inside]
            src += [lo, hi]
            dst += [hi, lo]
        return np.concatenate(src), np.concatenate(dst)

    def edge_arrays(self):
        empty = np.zeros((0, 3), dtype=np.int64)
        return empty, empty


def variant_sources(source: str, out_dir: Path) -> dict:
    """Write each variant's source; fail if a replacement finds nothing."""
    text = Path(source).read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (edits, _) in VARIANTS.items():
        body = text
        for old, new in edits:
            if body.count(old) != 1:
                raise SystemExit(f"variant {name}: the text to replace occurs {body.count(old)} times in {source}")
            body = body.replace(old, new)
        path = out_dir / f"{name}.cu"
        path.write_text(body)
        paths[name] = path
    return paths


def build(paths: dict, include: Path) -> dict:
    from bodge_tpu_torch.ops import _build

    started = {}
    for name, src in paths.items():
        target = src.with_suffix(".so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(include), "-o", str(target), str(src)]
        started[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), target)
    libs = {}
    for name, (proc, target) in started.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{out}")
        lib = ctypes.CDLL(str(target))
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.ell_gather_spmm_launch.argtypes = [p, i, p, p, p, ll, i, i, i, i, i, i, ll, i, i, p]
        lib.ell_gather_cheb_step_launch.argtypes = [p, i, p, p, p, p, p, f, ll, i, i, i, i, i, i, ll, i, i, p]
        lib.ell_gather_spmm_launch.restype = lib.ell_gather_cheb_step_launch.restype = i
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", required=True, help="a one-block ell_gather.cu")
    ap.add_argument("--out", default="chiprun_out/gather_variants.json")
    ap.add_argument("--package", action="store_true", help="also time the package's own gather kernels")
    ap.add_argument("--tiles", default="", help="with --package: forced bf16 plans T:stages, comma-separated")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("gather_variants: no CUDA device", file=sys.stderr)
        return 1
    from bodge_tpu_torch.ops import blocksparse as bs
    from bodge_tpu_torch.ops import cuda_gather as cg
    from bodge_tpu_torch.ops import cuda_spmm as ck

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    libs = build(variant_sources(args.source, ROOT / "build" / "variants"), ROOT / "bodge_tpu_torch" / "csrc")

    sk = bs.skeleton_from_lattice(HoleSheet(1024, 256, 60))
    K = 8
    gl = cg.plan_gather(sk, K)  # the float32 plan: the one-block form
    N, S = sk.cols.shape
    g = torch.Generator(device="cpu").manual_seed(7)
    data = gl.relabel(torch.randn((N, S, 4, 4), dtype=torch.complex64, generator=g).to(dev)).contiguous()
    forms = {"f32": data, "bf16": ck.bf16_operator(data)}
    v = torch.randn((N, 4, K), dtype=torch.complex64, generator=g).to(dev)
    prev = torch.randn((N, 4, K), dtype=torch.complex64, generator=g).to(dev)
    out = torch.empty_like(v)
    rel = gl.device_rel(dev)
    stream = torch.cuda.current_stream().cuda_stream

    def plan_of(change):
        T, TK, D, run, ctas, threads = gl.T, gl.TK, gl.depth, gl.run, gl.ctas, gl.threads
        if change == "tile64":
            T64 = cg.plan_gather(sk, K, (64, gl.run))
            T, TK, D, run, ctas, threads = T64.T, T64.TK, T64.depth, T64.run, T64.ctas, T64.threads
        elif change == "threads512":
            threads = 512
        return T, TK, D, run, ctas, threads

    fns, plans = {}, {}
    for name, lib in libs.items():
        T, TK, D, run, ctas, threads = plans[name] = plan_of(VARIANTS[name][1])
        partials = torch.empty((ctas, 2 * K), dtype=torch.float32, device=dev)
        for form, d in forms.items():
            bf16 = int(form == "bf16")

            def spmm(lib=lib, d=d, bf16=bf16, T=T, TK=TK, D=D, run=run, ctas=ctas, threads=threads):
                err = lib.ell_gather_spmm_launch(d.data_ptr(), bf16, rel.data_ptr(), v.data_ptr(), out.data_ptr(),
                                                 N, S, K, TK, T, gl.bwb, D, run, ctas, threads, stream)
                assert err == 0, f"launch refused: {err}"

            def step(lib=lib, d=d, bf16=bf16, T=T, TK=TK, D=D, run=run, ctas=ctas, threads=threads,
                     partials=partials):
                err = lib.ell_gather_cheb_step_launch(
                    d.data_ptr(), bf16, rel.data_ptr(), v.data_ptr(), prev.data_ptr(), out.data_ptr(),
                    partials.data_ptr(), 0.125, N, S, K, TK, T, gl.bwb, D, run, ctas, threads, stream)
                assert err == 0, f"launch refused: {err}"

            fns[f"{name} {form} product"] = spmm
            fns[f"{name} {form} step"] = step
    for form, d in forms.items():
        fns[f"ell_spmm {form} relabelled"] = lambda d=d: ck.ell_spmm(d, gl.sk, v)
        fns[f"ell_cheb_step {form} relabelled"] = lambda d=d: ck.ell_cheb_step(d, gl.sk, v, prev, 0.125, out=out)
    if args.package:
        for form, d in forms.items():
            layout = cg.plan_gather(sk, K, operator_dtype=None if form == "f32" else "bf16")
            fns[f"package {form} product"] = lambda d=d, lay=layout: cg.ell_gather_spmm(d, lay, v)
            fns[f"package {form} step"] = lambda d=d, lay=layout: cg.ell_gather_cheb_step(d, lay, v, prev, 0.125,
                                                                                            out=out)
        for spec in filter(None, args.tiles.split(",")):
            T, stages = map(int, spec.split(":"))
            layout = cg.plan_gather(sk, K, (T, None, stages), operator_dtype="bf16")
            if layout is None or layout.cluster != 2:
                continue
            name = f"package bf16 T={T} stages={stages} threads={layout.threads}"
            plans[name] = [layout.T, layout.TK, layout.depth, layout.run, layout.ctas, layout.threads,
                           layout.cluster, layout.stage_bytes, layout.smem_bytes]
            fns[name + " product"] = lambda lay=layout: cg.ell_gather_spmm(forms["bf16"], lay, v)
            fns[name + " step"] = lambda lay=layout: cg.ell_gather_cheb_step(forms["bf16"], lay, v, prev, 0.125,
                                                                             out=out)

    errors = {}
    for form, d in forms.items():
        want = cg.ell_gather_spmm_plain(d, gl, v)
        for name in libs:
            fns[f"{name} {form} product"]()
            torch.cuda.synchronize()
            errors[f"{name} {form} product"] = float((out - want).abs().max())
        if args.package:
            layout = cg.plan_gather(sk, K, operator_dtype=None if form == "f32" else "bf16")
            y, y_again = cg.ell_gather_spmm(d, layout, v), cg.ell_gather_spmm(d, layout, v)
            t, pp = cg.ell_gather_cheb_step(d, layout, v, prev, 0.125)
            t_again, pp_again = cg.ell_gather_cheb_step(d, layout, v, prev, 0.125)
            t_want, _ = cg.ell_gather_cheb_step_plain(d, gl, v, prev, 0.125)
            torch.cuda.synchronize()
            errors[f"package {form} product"] = float((y - want).abs().max())
            errors[f"package {form} step"] = float((t - t_want).abs().max())
            errors[f"package {form} repeats bit for bit"] = float(
                torch.equal(y, y_again) and torch.equal(t, t_again) and torch.equal(pp, pp_again))
            plans[f"package {form}"] = [layout.T, layout.TK, layout.depth, layout.run, layout.ctas, layout.threads,
                                        layout.cluster, layout.stage_bytes, layout.smem_bytes]

    def timed_ms(fn):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    runs = {name: [timed_ms(fn)] for name, fn in fns.items()}
    for name, fn in reversed(list(fns.items())):
        runs[name].append(timed_ms(fn))
    result = {"nvidia_smi": smi, "kind": torch.cuda.get_device_name(0), "N": N, "S": S, "K": K, "bwb": gl.bwb,
              "plans_T_TK_depth_run_ctas_threads[_cluster_stage_smem]": plans, "reps": args.reps,
              "ms": {name: min(r) for name, r in runs.items()}, "runs_ms": runs, "max_abs_err": errors}
    for name, ms in result["ms"].items():
        print(f"{name:32s} {ms:.4f} ms")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({"ms": result["ms"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
