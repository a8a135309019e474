#!/usr/bin/env python3
"""Same-call A/B of two sources of the BDT kernel (B4,
src/repro_torch/kernels/csrc/bdt_infer.cu), of the bit-sliced fabric
walk (K2, csrc/bitsliced.cu) or of the egress kernel (B6,
csrc/sparse_pack.cu) on one CUDA card, B6's dense entry against the torch
chain it replaces, and K2's tile sweep. Run from the repo root:

    python3 benchmarks/torch_kernel_ab.py b4 A.cu B.cu
    python3 benchmarks/torch_kernel_ab.py k2 A.cu B.cu
    python3 benchmarks/torch_kernel_ab.py b6 A.cu B.cu
    python3 benchmarks/torch_kernel_ab.py b6-dense
    python3 benchmarks/torch_kernel_ab.py k2-tiles

b4       — both sources built side by side and timed in turns (A, B, B,
           A) at chip_smoke's shapes: the paper chip's golden ensemble
           at B=512 and B=65,536, each exact against bdt_traverse_plain.
           A source that exports bdt_infer_scratch_bytes takes the
           node-table scratch pointer (the tree walk); one without it is
           driven with the earlier signature (no scratch; the
           node-parallel product kernel) at that kernel's own tile rule
           (the largest of 32/16/8 events whose 4 x P x tile f32 fit and
           that gives every SM a block).
k2       — the same for two sources of eval_words_voted_launch on
           chip_smoke's 4-chip envelope, W=16 and W=256 words, R=1 and
           R=3, at the tile eval_seg_voted picks, each exact against
           eval_seg_voted_plain. A source that exports
           eval_words_voted_scratch_bytes takes the descriptor scratch
           pointer; one without it is driven with the earlier signature
           (no scratch; the per-item loads of the first kernel).
b6       — the same for two sources of sparse_pack_launch at chip_smoke's
           timing shapes (4 chips x 16 and x 2,048 words, R=3, O=28, the
           plan's rows, about half kept): the decode-pack entry and the
           keep-words entry, each exact against its plain twin. A source
           that exports sparse_pack_state_words takes the persistent
           state (one launch an entry); one without it is driven with
           the earlier signature (a scratch of 2*C*W words; a memset and
           three kernels).
b6-phases — a copy of the committed B6 source with %globaltimer stamps
           by thread 0 of the first and the last block of each entry
           (start, words loaded, padded, looked back, scattered, counted
           done, end), and an empty kernel of the same grid: where one
           launch's time goes, at the same shapes.
b6-dense — the torch chain the dense path ran (unpack_words, then
           decode_scores_device) against B6's dense entry, in turns, at
           the same shapes, each exact against the chain on the CPU.
k2-tiles — the committed K2 source at every tile that fits, same shapes.
b4-tiles — the committed B4 source at every events-per-block tile from 8
           to 256, at B=512 and B=65,536.
b4-phases — a copy of the committed B4 source with %globaltimer stamps by
           thread 0 of the table pass's first block and of walk blocks 0
           and the last: start, node table staged, end; at B=65,536.
k2-phases — a copy of the committed K2 source with %globaltimer stamps
           (ns) by thread 0 of the descriptor pass's first block and of
           the walk's block (0, 0) at its start, after its set-up, after
           its levels and at its end, and clock64 cycles per level (one
           slot a thread): where one launch's time goes, same shapes.

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
from repro_torch.kernels.bdt_infer import bdt_infer as bdt  # noqa: E402
from repro_torch.kernels.bdt_infer import ops as bdt_ops  # noqa: E402
from repro_torch.kernels.lut_eval import bitsliced as bs  # noqa: E402
from repro_torch.kernels.lut_eval import ops as lut_ops  # noqa: E402
from repro_torch.kernels.sparse_pack import sparse_pack as sp  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


def compile_lib(src, name):
    """nvcc `src` with the kernels' flags into _build/probe-<name>.so."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = build.BUILD_DIR / f"probe-{name}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def load_pair(src_a, src_b, kernel):
    """Both sources built side by side, their error strings bound."""
    libs = {k: compile_lib(src, f"{kernel}-{k}")
            for k, src in (("A", src_a), ("B", src_b))}
    for lib in libs.values():
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return libs


def in_turns(libs, launcher, want, out_of, name):
    """Time A, B, B, A (each launch checked against `want` first): back
    to back from the host (`ms`) and replayed from a CUDA graph
    (`graph_ms`, no host launch cost)."""
    row = {"A": [], "B": [], "graph_A": [], "graph_B": []}
    for k in ("A", "B", "B", "A"):
        go, out = launcher(libs[k])
        go()
        torch.cuda.synchronize()
        for o, w in zip(out_of(out), want):
            if not torch.equal(o, w):
                raise RuntimeError(f"{name}: source {k} differs from the "
                                   "plain twin")
        row[k].append(cs.time_ms(go, reps=20, inner=10))
        row["graph_" + k].append(cs.graph_ms(go))
    return row


def product_kernel_tile(P, B, n_sms):
    """The product kernel's tile rule (events per block)."""
    fits = [t for t in (32, 16, 8) if 16 * P * t <= build.SMEM_LIMIT_BYTES]
    for t in fits:
        if -(-B // t) >= n_sms:
            return t
    return fits[-1]


def b4_launcher(x, arrays, depth, n_sms):
    B, F = x.shape
    P = arrays[0].shape[1]
    ptrs = [x.data_ptr()] + [a.data_ptr() for a in arrays]

    def make(lib):
        fn = lib.bdt_infer_launch
        fn.restype = ctypes.c_int
        out = torch.empty((B, bdt.OUT_COLS), dtype=torch.int32,
                          device="cuda")
        if hasattr(lib, "bdt_infer_scratch_bytes"):
            fn.argtypes = list(build.PROTOTYPES["bdt_infer"]["bdt_infer_launch"])
            scratch = bdt.scratch_for(P, x.device)
            tile = bdt.bdt_tile(P, F, B, n_sms)
            args = ptrs + [scratch.data_ptr(), out.data_ptr()]
        else:
            fn.argtypes = [_P] * 9 + [_I] * 5 + [_P]
            tile = product_kernel_tile(P, B, n_sms)
            args = ptrs + [out.data_ptr()]

        def go():
            stream = torch.cuda.current_stream().cuda_stream
            build.check(lib, fn(*args, B, F, P, depth, tile, stream),
                        "bdt_infer A/B")
        return go, out
    return make


def b4_case():
    """The paper chip's packed golden ensemble and raw features of the
    first §5 chunk."""
    chip, te, _ = cs.paper_chip()
    packed = bdt_ops.pack_ensemble(chip.golden, 14, device="cuda")
    arrays = tuple(build.aligned(getattr(packed, k)) for k in (
        "featsel", "thr", "root_onehot", "left", "right", "value_hi",
        "value_lo"))
    x_raw = chip.golden.quantize_features(
        te["features"][:cs.S5_CHUNK]).astype(np.int32)
    return packed.depth, arrays, x_raw


def stamped_b4_source():
    """csrc/bdt_infer.cu with %globaltimer stamps and read_stamps(host):
    ns[0] table pass start; ns[1..3] walk block 0 start / staged / end;
    ns[4..6] the same for the last block."""
    src = (build.CSRC / "bdt_infer.cu").read_text()

    def put(anchor, text, after=True):
        nonlocal src
        if src.count(anchor) != 1:
            raise RuntimeError(f"stamp anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + text if after else text + anchor)

    put("namespace {\n", (
        "__device__ unsigned long long g_ns[8];\n"
        "__device__ __forceinline__ unsigned long long gtime() {\n"
        "  unsigned long long t;\n"
        '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));\n'
        "  return t;\n}\n"
        "#define NS(i) do { if (threadIdx.x == 0 && blockIdx.x == 0) "
        "g_ns[i] = gtime(); if (threadIdx.x == 0 && blockIdx.x == "
        "gridDim.x - 1) g_ns[(i) + 3] = gtime(); } while (0)\n"))
    put("  if (p >= P) return;                                // warp-uniform\n",
        "  if (p == 0 && lane == 0) g_ns[0] = gtime();\n", after=False)
    put("  const int n_ev = min(tile, B - b0);\n\n", "  NS(1);\n")
    put("  const int n_warps = blockDim.x >> 5;\n", "  NS(2);\n")
    put("    o[16] = halves4(hi1, lo1);\n  }\n",
        "  NS(3);\n")
    put('extern "C" {\n', (
        "int read_stamps(unsigned long long* ns) {\n"
        "  return (int)cudaMemcpyFromSymbol(ns, g_ns, sizeof(g_ns));\n}\n"))
    return src


def b4_phases():
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / "probe-b4-stamped.cu"
    path.write_text(stamped_b4_source())
    lib = compile_lib(path, "b4-stamped")
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    depth, arrays, x_raw = b4_case()
    x = torch.as_tensor(x_raw, device="cuda")
    go, _ = b4_launcher(x, arrays, depth, n_sms)(lib)
    ms = cs.graph_ms(go)         # the stamps of its last replayed call
    torch.cuda.synchronize()
    ns = (ctypes.c_ulonglong * 8)()
    if lib.read_stamps(ns) != 0:
        raise RuntimeError("read_stamps failed")
    t0 = ns[0]
    print(json.dumps({
        "probe": "b4_phases", "events": x.shape[0], "graph_ms": ms,
        "tile": bdt.bdt_tile(arrays[0].shape[1], x.shape[1], x.shape[0],
                             n_sms),
        "first_block_ns_from_table_start": [ns[i] - t0 for i in (1, 2, 3)],
        "last_block_ns_from_table_start": [ns[i] - t0 for i in (4, 5, 6)]}),
        flush=True)


def b4_tiles():
    lib = build.load("bdt_infer")
    depth, arrays, x_raw = b4_case()
    P = arrays[0].shape[1]
    for B in (cs.SERVED_B, cs.S5_CHUNK):
        x = torch.as_tensor(x_raw[:B], device="cuda")
        want = bdt.bdt_traverse_plain(x, *arrays, depth=depth)
        out = torch.empty_like(want)
        scratch = bdt.scratch_for(P, x.device)
        row = {}
        for tile in (8, 16, 32, 64, 128, 256):
            def go(tile=tile):
                stream = torch.cuda.current_stream().cuda_stream
                build.check(lib, lib.bdt_infer_launch(
                    x.data_ptr(), *[a.data_ptr() for a in arrays],
                    scratch.data_ptr(), out.data_ptr(), B, x.shape[1], P,
                    depth, tile, stream), "bdt_infer tiles")
            out.zero_()
            go()
            torch.cuda.synchronize()
            row[f"T{tile}"] = {"exact": bool(torch.equal(out, want)),
                               "graph_ms": cs.graph_ms(go)}
        n_sms = torch.cuda.get_device_properties(0).multi_processor_count
        print(json.dumps({"probe": "b4_tiles", "events": B,
                          "rule": bdt.bdt_tile(P, x.shape[1], B, n_sms), **row}),
              flush=True)


def ab_b4(src_a, src_b):
    libs = load_pair(src_a, src_b, "b4")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    depth, arrays, x_raw = b4_case()
    for B in (cs.SERVED_B, cs.S5_CHUNK):
        x = torch.as_tensor(x_raw[:B], device="cuda")
        want = (bdt.bdt_traverse_plain(x, *arrays, depth=depth),)
        row = in_turns(libs, b4_launcher(x, arrays, depth, n_sms),
                       want, lambda o: (o,), f"bdt_infer B={B}")
        print(json.dumps({"probe": "ab_b4", "events": B, **row}),
              flush=True)


def k2_cases():
    """(name, args of eval_seg_voted_plain) on chip_smoke's envelope."""
    chips = [cs.train_chip(2024 + i, depth=5 - (i % 2), leaves=10 - (i % 3))
             for i in range(cs.N_CHIPS)]
    rng = np.random.default_rng(12)
    for red in ("none", "tmr"):
        s = lut_ops.pack_fabrics([c.config for c in chips], redundancy=red,
                                 layout="bitsliced", device="cuda")
        for W in (cs.SERVED_B // 32, cs.K2_WORDS):
            bits = torch.as_tensor(
                rng.integers(0, 2, (cs.N_CHIPS, W * 32, s.n_inputs)),
                dtype=torch.int32, device="cuda")
            seg = bs.input_words(bits, s.n_inputs, s.in_seg)
            yield (f"R{s.n_replicas}_W{W}",
                   (build.aligned(s.src), build.aligned(s.tables),
                    s.output_nets.contiguous(), seg, s.n_replicas))


def k2_launcher(args, tile):
    src, tables, output_nets, seg, R = args
    C, W, in_seg = seg.shape
    L, M, O = src.shape[1], src.shape[2], output_nets.shape[1]

    def make(lib):
        fn = lib.eval_words_voted_launch
        fn.restype = ctypes.c_int
        voted = torch.empty((C, W, O), dtype=torch.int32, device="cuda")
        dis = torch.empty((C, R, W), dtype=torch.int32, device="cuda")
        ptrs = [seg.data_ptr(), src.data_ptr(), tables.data_ptr(),
                output_nets.data_ptr()]
        if hasattr(lib, "eval_words_voted_scratch_bytes"):
            fn.argtypes = list(build.PROTOTYPES["bitsliced"]["eval_words_voted_launch"])
            scratch = bs.scratch_for(C, R, L, M, seg.device)
            ptrs.append(scratch.data_ptr())
        else:
            fn.argtypes = [_P] * 6 + [_I] * 8 + [_P]
        ptrs += [voted.data_ptr(), dis.data_ptr()]

        def go():
            stream = torch.cuda.current_stream().cuda_stream
            build.check(lib, fn(*ptrs, C, R, W, in_seg, L, M, O, tile,
                                stream), "bitsliced A/B")
        return go, (voted, dis)
    return make


def k2_tile(args, n_sms):
    src, _, _, seg, R = args
    C, W, in_seg = seg.shape
    return bs.word_tile(R, in_seg, src.shape[1], src.shape[2], W, C, n_sms)


def ab_k2(src_a, src_b):
    libs = load_pair(src_a, src_b, "k2")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, args in k2_cases():
        tile = k2_tile(args, n_sms)
        want = bs.eval_seg_voted_plain(*args)
        row = in_turns(libs, k2_launcher(args, tile), want, lambda o: o,
                       f"bitsliced {name}")
        print(json.dumps({"probe": "ab_k2", "case": name, "tile": tile,
                          **row}), flush=True)


def k2_tiles():
    lib = build.load("bitsliced")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, args in k2_cases():
        src, _, _, seg, R = args
        C, W, in_seg = seg.shape
        L, M = src.shape[1], src.shape[2]
        want = bs.eval_seg_voted_plain(*args)
        row = {}
        for tile in (1, 2, 4, 8, 9, 16):
            if tile > W or bs.smem_bytes(R, in_seg, L, M, tile) > \
                    build.SMEM_LIMIT_BYTES:
                continue
            go, out = k2_launcher(args, tile)(lib)
            go()
            torch.cuda.synchronize()
            row[f"T{tile}"] = {
                "exact": all(torch.equal(o, w) for o, w in zip(out, want)),
                "ms": cs.time_ms(go, reps=20, inner=10),
                "graph_ms": cs.graph_ms(go)}
        print(json.dumps({"probe": "k2_tiles", "case": name,
                          "rule": k2_tile(args, n_sms), **row}), flush=True)


def stamped_k2_source():
    """csrc/bitsliced.cu with timer stamps and a read_stamps(host) C
    function: ns[0] descriptor pass start, ns[1..4] walk block (0, 0)
    start / set-up done / levels done / end; cyc[l] at the end of
    level l."""
    src = (build.CSRC / "bitsliced.cu").read_text()

    def put(anchor, text, after=True):
        nonlocal src
        if src.count(anchor) != 1:
            raise RuntimeError(f"stamp anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + text if after else text + anchor)

    put("namespace {\n", (
        "__device__ unsigned long long g_ns[8];\n"
        "__device__ long long g_cyc[64];\n"
        "__device__ __forceinline__ unsigned long long gtime() {\n"
        "  unsigned long long t;\n"
        '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));\n'
        "  return t;\n}\n"
        "#define NS(i) do { if (threadIdx.x == 0 && blockIdx.x == 0 && "
        "blockIdx.y == 0) g_ns[i] = gtime(); } while (0)\n"
        "#define CYC(i) do { if (threadIdx.x == 0 && blockIdx.x == 0 && "
        "blockIdx.y == 0 && (i) < 64) g_cyc[i] = clock64(); } while (0)\n"))
    put("  if (k >= n) return;\n", "  if (k == 0) g_ns[0] = gtime();\n")
    put("  const int tid = threadIdx.x, bd = blockDim.x;\n",
        "  NS(1);\n  CYC(0);\n")
    put("  cp_async_wait_all();\n  __syncthreads();\n", "  NS(2);\n")
    put("      d = dn;\n", "      CYC(l + 1);\n", after=False)
    put("  // output gather", "  NS(3);\n", after=False)
    put("    dis[((size_t)c * R + r) * W + w0 + t] = dis_s[r * T + t];\n"
        "  }\n", "  NS(4);\n")
    put('extern "C" {\n', (
        "int read_stamps(unsigned long long* ns, long long* cyc) {\n"
        "  cudaError_t e = cudaMemcpyFromSymbol(ns, g_ns, sizeof(g_ns));\n"
        "  if (e == cudaSuccess)\n"
        "    e = cudaMemcpyFromSymbol(cyc, g_cyc, sizeof(g_cyc));\n"
        "  return (int)e;\n}\n"))
    return src


def k2_phases():
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / "probe-k2-stamped.cu"
    path.write_text(stamped_k2_source())
    lib = compile_lib(path, "k2-stamped")
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, args in k2_cases():
        go, _ = k2_launcher(args, k2_tile(args, n_sms))(lib)
        ms = cs.graph_ms(go)     # the stamps of its last replayed call
        torch.cuda.synchronize()
        ns = (ctypes.c_ulonglong * 8)()
        cyc = (ctypes.c_longlong * 64)()
        if lib.read_stamps(ns, cyc) != 0:
            raise RuntimeError("read_stamps failed")
        L = args[0].shape[1]
        print(json.dumps({
            "probe": "k2_phases", "case": name, "graph_ms": ms,
            "desc_start_to_walk_start_ns": ns[1] - ns[0],
            "walk_setup_ns": ns[2] - ns[1], "walk_levels_ns": ns[3] - ns[2],
            "walk_output_ns": ns[4] - ns[3],
            "level_cycles": [cyc[l + 1] - cyc[l] for l in range(L)]}),
            flush=True)


def b6_cases():
    """(words, decode args, keep words, lane scores) at chip_smoke's B6
    timing shapes."""
    for words in (cs.SERVED_B // 32, cs.B6_WORDS):
        args = cs.b6_case(torch, np, bs, cs.N_CHIPS, words, 3, 28, "plan",
                          0.5, seed=17)
        keep_w, scores, _ = lut_ops.decode_keep_words_device(*args)
        yield words, args, keep_w.contiguous(), scores.contiguous()


def b6_launcher(args, keep_w, scores, decode):
    """A launch of one B6 source's decode-pack (``decode``) or
    keep-words entry into preallocated outputs."""
    voted, dis, weight, thr, valid = args
    C, W, O = voted.shape
    R, B = dis.shape[1], valid.shape[1]
    n = C * W * 32

    def make(lib):
        fn = lib.sparse_pack_launch
        fn.restype = ctypes.c_int
        out = (torch.empty((), dtype=torch.int32, device="cuda"),
               torch.empty(n, dtype=torch.int32, device="cuda"),
               torch.empty(n, dtype=torch.int32, device="cuda"),
               torch.empty((C, R), dtype=torch.int32, device="cuda"))
        ins = ([t.data_ptr() for t in args] + [None, None] if decode
               else [None] * 5 + [keep_w.data_ptr(), scores.data_ptr()])
        outs = [t.data_ptr() for t in out[:3]] + [
            out[3].data_ptr() if decode else None]
        dims = [C, W, O, R, B] if decode else [C, W, 0, 0, 0]
        stateful = hasattr(lib, "sparse_pack_state_words")
        if stateful:
            fn.argtypes = list(
                build.PROTOTYPES["sparse_pack"]["sparse_pack_launch"])
        else:
            fn.argtypes = [_P] * 12 + [_I] * 5 + [_P]
            scratch = torch.empty(2 * C * W, dtype=torch.int32,
                                  device="cuda")

        def go():
            stream = torch.cuda.current_stream().cuda_stream
            if stateful:    # the state of the stream it launches on
                st = sp._state(voted.device, stream,
                               sp.state_words(C, R, W))
                ptrs, tail = ins + [st.data_ptr()] + outs, [st.numel()]
            else:
                ptrs, tail = ins + [scratch.data_ptr()] + outs, []
            build.check(lib, fn(*ptrs, *dims, *tail, stream),
                        "sparse_pack A/B")
        return go, out if decode else out[:3]
    return make


def ab_b6(src_a, src_b):
    libs = load_pair(src_a, src_b, "b6")
    for words, args, keep_w, scores in b6_cases():
        for decode in (True, False):
            want = (sp.decode_pack_plain(*args) if decode
                    else sp.pack_words_plain(keep_w, scores))
            row = in_turns(libs, b6_launcher(args, keep_w, scores, decode),
                           want, lambda o: o, f"sparse_pack W={words}")
            print(json.dumps({"probe": "ab_b6", "words": words,
                              "entry": "decode_pack" if decode
                              else "keep_words", **row}), flush=True)


def ab_b6_dense():
    """A = the torch chain, B = the dense entry."""
    for words, args, _, _ in b6_cases():
        want = sp.decode_dense_plain(*[t.cpu() for t in args])
        held = []

        def make(which):
            def go():
                fn = (sp.decode_dense_plain if which == "A"
                      else sp.decode_dense)
                held[:] = fn(*args)
            return go, held
        row = in_turns({"A": "A", "B": "B"}, make, want,
                       lambda o: [t.cpu() for t in o],
                       f"decode_dense W={words}")
        print(json.dumps({"probe": "ab_b6_dense", "words": words,
                          "A": "unpack_words + decode_scores_device",
                          "B": "sparse_pack.cu dense entry", **row}),
              flush=True)


def stamped_b6_source():
    """csrc/sparse_pack.cu with %globaltimer stamps, an empty kernel and
    C functions read_stamps(host) and empty_launch(blocks, stream):
    ns[i] stamp i of block 0, ns[16 + i] of the last block; stamps 0
    start, 1 after the wait and the prologue's loads, 2 decoded, 3 counts added, 4 looked back, 5
    scattered / written, 6 the last tile's wait for every prefix, 7 end
    (of a single block, or of the last)."""
    src = (build.CSRC / "sparse_pack.cu").read_text()

    def put(anchor, text, after=True):
        nonlocal src
        if src.count(anchor) != 1:
            raise RuntimeError(f"stamp anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + text if after else text + anchor)

    put("namespace {\n", (
        "__device__ unsigned long long g_ns[32];\n"
        "__device__ __forceinline__ unsigned long long gtime() {\n"
        "  unsigned long long t;\n"
        '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));\n'
        "  return t;\n}\n"
        "#define S(i) do { if (threadIdx.x == 0) { if (blockIdx.x == 0) "
        "g_ns[i] = gtime(); if (blockIdx.x == gridDim.x - 1) "
        "g_ns[16 + (i)] = gtime(); } } while (0)\n"
        "__global__ void empty_kernel() {}\n"))
    put("  wait_for_prior_grids();\n  Prologue p[kWordsPerWarp] = {};\n",
        "  S(0);\n", after=False)
    put("  // a block of several pads its slot range", "  S(1);\n",
        after=False)
    put("  if (!single) add_counts(", "  S(2);\n", after=False)
    put("  if (warp == 0) {\n    // word bases", "  S(3);\n", after=False)
    put("  const int prefix = s_prefix;\n", "  S(4);\n", after=False)
    put("  if (single) {  ", "  S(5);\n", after=False)
    put("    for (int i = threadIdx.x; i < C * R; i += kThreads) dis[i] = "
        "s_dis[i];\n    return;\n  }\n  if (!last)",
        "    S(7);\n", after=False)
    put("  // the last tile: once every other tile", "  S(6);\n",
        after=False)
    put("  for (int q = threadIdx.x; q < t; q += kThreads) status[q] = 0u;\n",
        "  S(7);\n")
    put("  wait_for_prior_grids();\n  Prologue p[kWordsPerWarp];\n",
        "  S(0);\n", after=False)
    put("  __syncthreads();\n\n  unsigned mine[kWordsPerWarp], "
        "dword[kWordsPerWarp];\n", "  S(1);\n")
    put("  if (gridDim.x == 1) {  ", "  S(5);\n", after=False)
    put("  if (threadIdx.x == 0) state[0] = 0u;\n", "  S(7);\n")
    put('extern "C" {\n', (
        "int read_stamps(unsigned long long* ns) {\n"
        "  return (int)cudaMemcpyFromSymbol(ns, g_ns, sizeof(g_ns));\n}\n"
        "int clear_stamps() {\n"
        "  const unsigned long long z[32] = {};\n"
        "  return (int)cudaMemcpyToSymbol(g_ns, z, sizeof(z));\n}\n"
        "int empty_launch(int blocks, void* stream) {\n"
        "  empty_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>();\n"
        "  return (int)cudaGetLastError();\n}\n"))
    return src


def b6_phases():
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / "probe-b6-stamped.cu"
    path.write_text(stamped_b6_source())
    lib = compile_lib(path, "b6-stamped")
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    for fn_name, argtypes in build.PROTOTYPES["sparse_pack"].items():
        getattr(lib, fn_name).argtypes = list(argtypes)
        getattr(lib, fn_name).restype = ctypes.c_int
    lib.empty_launch.argtypes = [_I, _P]
    for words, args, keep_w, scores in b6_cases():
        C = args[0].shape[0]
        blocks = -(-C * words // sp.TILE_WORDS)
        empty = cs.graph_ms(lambda: lib.empty_launch(
            blocks, torch.cuda.current_stream().cuda_stream))
        row = {"probe": "b6_phases", "words": words, "blocks": blocks,
               "empty_graph_ms": empty}
        for entry in ("decode_pack", "keep_words", "dense"):
            if entry == "dense":
                outs = sp.decode_dense_plain(*args)
                go = lambda: sp.launch_dense(  # noqa: E731
                    *args, *outs, C, words, args[0].shape[2],
                    args[1].shape[1], args[4].shape[1])
            else:
                go, _ = b6_launcher(args, keep_w, scores,
                                    entry == "decode_pack")(lib)
            saved = build._LIBS.get("sparse_pack")
            build._LIBS["sparse_pack"] = lib
            try:
                ms = cs.graph_ms(go)
                torch.cuda.synchronize()
            finally:
                if saved is None:
                    build._LIBS.pop("sparse_pack")
                else:
                    build._LIBS["sparse_pack"] = saved
            ns = (ctypes.c_ulonglong * 32)()
            if lib.read_stamps(ns) != 0 or lib.clear_stamps() != 0:
                raise RuntimeError("read_stamps failed")
            t0 = ns[0]
            # a stamp older than this call's first (the dense entry's
            # stamp 7 is the last block's only when it counted done last)
            row[entry] = {
                "graph_ms": ms,
                "block0_ns": [ns[i] - t0 if ns[i] >= t0 else None
                              for i in range(8)],
                "last_block_ns": [ns[16 + i] - t0 if ns[16 + i] >= t0
                                  else None for i in range(8)]}
        print(json.dumps(row), flush=True)


def main():
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode == "b4" and len(sys.argv) == 4:
        ab_b4(sys.argv[2], sys.argv[3])
    elif mode == "k2" and len(sys.argv) == 4:
        ab_k2(sys.argv[2], sys.argv[3])
    elif mode == "b6" and len(sys.argv) == 4:
        ab_b6(sys.argv[2], sys.argv[3])
    elif mode == "b6-dense":
        ab_b6_dense()
    elif mode == "b6-phases":
        b6_phases()
    elif mode == "k2-tiles":
        k2_tiles()
    elif mode == "k2-phases":
        k2_phases()
    elif mode == "b4-tiles":
        b4_tiles()
    elif mode == "b4-phases":
        b4_phases()
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
