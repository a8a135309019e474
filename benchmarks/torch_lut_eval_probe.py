#!/usr/bin/env python3
"""Measurements of the port's selection-matmul kernel (B2/B3,
src/repro_torch/kernels/csrc/lut_eval.cu) on one CUDA card, beyond what
chip_smoke.py records. Run from the repo root:

    python3 benchmarks/torch_lut_eval_probe.py tiles
    python3 benchmarks/torch_lut_eval_probe.py phases
    python3 benchmarks/torch_lut_eval_probe.py ab A.cu B.cu

tiles  — at the §5 chunk shape (chip_smoke.paper_chip, C=1, B=65,536),
         banded and dense: every events-per-block tile that fits, exact
         against lut_eval_plain, and its time (CUDA events); and the
         time of one 16-event launch (the column-list pass plus one
         block).
phases — clock64 stamps taken by thread 0 of blocks 0 and 2048 at each
         phase boundary of the main pass, from a copy of the source with
         the stamps inserted (built into the git-ignored _build/): the
         cycles of the set-up, of each level (compute, copy-back, wait)
         and of the output, with the card's SM clock.
ab     — two sources of the same C interface built side by side and
         timed in turns (A, B, B, A) at the §5 chunk and at the served
         TMR shape (12 rows x 512 events), each exact against the twin.

Every line is JSON; the last names the card and its power limit.
"""
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.lut_eval import lut_eval as le  # noqa: E402
from repro_torch.kernels.lut_eval import ops as lut_ops  # noqa: E402

STAMPED_BLOCK = 2048                 # blocks 0 and this one are stamped


def compile_lib(src, name):
    """nvcc `src` with the kernels' flags into _build/, the lut_eval
    prototype set."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = build.BUILD_DIR / f"probe-{name}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn_name, argtypes in build.PROTOTYPES["lut_eval"].items():
        getattr(lib, fn_name).argtypes = list(argtypes)
        getattr(lib, fn_name).restype = ctypes.c_int
    return lib


def launcher(lib, ext, sel, tables, level_base, win, out, tile):
    """A no-argument launch of `lib` into `out`, scratch preallocated."""
    C, B, in_seg = ext.shape
    L, rows, M = sel.shape[1], sel.shape[2], sel.shape[3] // 4
    lists = torch.empty((C, L, 4 * M, le.LIST_CAP), dtype=torch.int32,
                        device="cuda")
    counts = torch.empty((C, L, 4 * M), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        code = lib.lut_eval_launch(
            ext.data_ptr(), sel.data_ptr(), tables.data_ptr(),
            level_base.data_ptr(), None if win is None else win.data_ptr(),
            lists.data_ptr(), counts.data_ptr(), out.data_ptr(), C, B,
            in_seg, L, rows, M, out.shape[2], tile, le.LIST_CAP, stream)
        build.check(lib, code, "lut_eval probe")
    return go


def chunk_cases():
    """(name, arrays, n_nets_pad) at the §5 chunk shape, banded then
    dense, on the first chunk of the paper chip's test split."""
    chip, te, _ = cs.paper_chip()
    bits_np = chip.encode_features(te["features"][:cs.S5_CHUNK])
    out = []
    for band in (None, False):
        p = lut_ops.pack_fabric(chip.config, band=band, device="cuda")
        bits = torch.as_tensor(bits_np, dtype=torch.int32, device="cuda")
        ext = lut_ops._bits_ext(bits, p.n_inputs, p.in_seg)[None]
        out.append(("chunk_" + ("banded" if p.banded else "dense"),
                    (ext, p.sel[None].contiguous(),
                     p.tables[None].contiguous(), p.level_base,
                     p.win_base if p.banded else None), p.n_nets_pad))
    return out


def served_cases():
    """The served TMR shape (12 rows x 512 events) on chip_smoke's 4-chip
    envelope, banded then dense."""
    chips = [cs.train_chip(2024 + i, depth=5 - (i % 2), leaves=10 - (i % 3))
             for i in range(cs.N_CHIPS)]
    rng = np.random.default_rng(13)
    out = []
    for band in (None, False):
        s = lut_ops.pack_fabrics([c.config for c in chips], band=band,
                                 redundancy="tmr", device="cuda")
        bits = torch.as_tensor(
            rng.integers(0, 2, (s.tables.shape[0], cs.SERVED_B, s.n_inputs)),
            dtype=torch.int32, device="cuda")
        ext = lut_ops._bits_ext(bits, s.n_inputs, s.in_seg)
        out.append(("served_" + s.layout,
                    (ext, s.sel, s.tables, s.level_base,
                     s.win_base if s.banded else None), s.n_nets_pad))
    return out


def tiles():
    lib = build.load("lut_eval")
    for name, arrays, N in chunk_cases():
        want = le.lut_eval_plain(*arrays, n_nets_pad=N)
        M = arrays[1].shape[3] // 4
        row = {}
        for tile in le.TILES:
            if le.smem_bytes(N, M, tile) > build.SMEM_LIMIT_BYTES:
                continue
            out = torch.zeros_like(want)
            go = launcher(lib, *arrays, out, tile)
            go()
            torch.cuda.synchronize()
            row[f"T{tile}"] = {"exact": bool(torch.equal(out, want)),
                               "ms": cs.time_ms(go, reps=10, inner=2)}
        small = (arrays[0][:, :16].contiguous(),) + arrays[1:]
        o16 = torch.empty((1, 16, N), device="cuda")
        row["one_block_ms"] = cs.time_ms(
            launcher(lib, *small, o16, 16), reps=10, inner=5)
        print(json.dumps({"probe": "tiles", name: row}), flush=True)
        del want


def stamped_source():
    """csrc/lut_eval.cu with clock64 stamps at the main pass's phase
    boundaries and a read_stamps(host) C function."""
    src = (build.CSRC / "lut_eval.cu").read_text()

    def put(anchor, text, after=True):
        nonlocal src
        if src.count(anchor) != 1:
            raise RuntimeError(f"stamp anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + text if after else text + anchor)

    put("namespace {\n", (
        "__device__ long long g_st[2][64];\n"
        "#define STAMP(i) do { if (threadIdx.x == 0 && blockIdx.y == 0 && "
        "(blockIdx.x == 0 || blockIdx.x == %d)) "
        "g_st[blockIdx.x ? 1 : 0][i] = clock64(); } while (0)\n"
        % STAMPED_BLOCK))
    put("  const int n_in = min(in_seg, N);\n", "  STAMP(0);\n")
    put("  const int Q = tile / 4;", "  STAMP(1);\n", after=False)
    put("    cp_async_wait_all();\n    __syncthreads();\n",
        "    if (l < 20) STAMP(2 + 3 * l);\n")
    put("      res4[it] = make_float4(o[0], o[1], o[2], o[3]);\n"
        "    }\n    __syncthreads();\n", "    if (l < 20) STAMP(3 + 3 * l);\n")
    put("    base = base_next;\n", "    if (l < 20) STAMP(4 + 3 * l);\n")
    put("  // out[c][b0 + t][n]", "  STAMP(62);\n", after=False)
    put("        make_float4(v[0], v[tile], v[2 * tile], v[3 * tile]);\n"
        "  }\n", "  __syncthreads();\n  STAMP(63);\n")
    put('extern "C" {\n', (
        "int read_stamps(long long* host) {\n"
        "  return (int)cudaMemcpyFromSymbol(host, g_st, sizeof(g_st));\n"
        "}\n"))
    return src


def phases():
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "probe-stamped.cu"
    src.write_text(stamped_source())
    lib = compile_lib(src, "stamped")
    for name, arrays, N in chunk_cases():
        L = arrays[1].shape[1]
        out = torch.empty((1, arrays[0].shape[1], N), device="cuda")
        go = launcher(lib, *arrays, out, 16)
        ms = cs.time_ms(go, reps=10, inner=2)
        st = (ctypes.c_longlong * 128)()
        if lib.read_stamps(st) != 0:
            raise RuntimeError("read_stamps failed")
        a = np.array(st[:], dtype=np.int64).reshape(2, 64)
        for blk, s in zip((0, STAMPED_BLOCK), a):
            levels = [[int(s[3 + 3 * l] - s[2 + 3 * l]),
                       int(s[4 + 3 * l] - s[3 + 3 * l]),
                       int(s[5 + 3 * l] - s[4 + 3 * l]) if l + 1 < L else 0]
                      for l in range(L)]
            print(json.dumps({
                "probe": "phases", "case": name, "tile": 16, "ms": ms,
                "block": blk, "setup_cycles": int(s[2] - s[0]),
                "level_compute_copy_wait_cycles": levels,
                "levels_cycles": int(s[62] - s[2]),
                "output_cycles": int(s[63] - s[62]),
                "total_cycles": int(s[63] - s[0])}), flush=True)


def ab(src_a, src_b):
    libs = {"A": compile_lib(src_a, "A"), "B": compile_lib(src_b, "B")}
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, arrays, N in chunk_cases() + served_cases():
        want = le.lut_eval_plain(*arrays, n_nets_pad=N)
        C, B = arrays[0].shape[:2]
        tile = le.lut_tile(N, arrays[1].shape[3] // 4, B, C, n_sms)
        row = {"A": [], "B": []}
        for k in ("A", "B", "B", "A"):
            out = torch.zeros_like(want)
            go = launcher(libs[k], *arrays, out, tile)
            go()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"{name}: source {k} differs from the "
                                   "plain twin")
            row[k].append(cs.time_ms(go, reps=20, inner=5))
        print(json.dumps({"probe": "ab", name: row, "tile": tile}),
              flush=True)
        del want


def main():
    if not torch.cuda.is_available():
        print("torch_lut_eval_probe: no CUDA device", file=sys.stderr)
        return 2
    mode = sys.argv[1] if len(sys.argv) > 1 else "tiles"
    if mode == "tiles":
        tiles()
    elif mode == "phases":
        phases()
    elif mode == "ab" and len(sys.argv) == 4:
        ab(sys.argv[2], sys.argv[3])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
