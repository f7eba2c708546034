"""The design choices of three kernels, measured against the variants
they were chosen over, on the card.

    python -m pase_tpu_torch.kernel_variants [conv] [serial] [train] [eval]
        [split] [fewlane] [--against SOURCE]

(no group named: all six). Each variant is a copy of the shipped source
with a few lines replaced (``VARIANTS``), built like the shipped kernels
into ``build/pase_tpu_torch/variants/`` (all at once) and called through
its own library:
  conv    ``conv_s1_tf32x3`` (csrc/conv_s1_tc.cu) with and without the
          promotion of each window's partial sums into float32 sums: max
          |y - y_plain| / max|y_plain| and ms at the seven trunk layers in
          float32 (``conv_proto.LAYERS``, B = 96);
  serial  ``qrnn_pool_fwd_seg`` (csrc/qrnn_pool.cu), seeded, as shipped and
          in each other tile of ``SEG_TILES`` (lanes, steps per segment
          and threads a block), and the one-thread-a-lane
          ``qrnn_pool_fwd``: ms at the streaming push shapes, around the
          route's limit and at the eval shape (``SERIAL_SHAPES``), in two
          passes (the second in reverse order), each output equal to the
          loop's bit for bit;
  train   ``qrnn_pool_fwd_train`` and ``qrnn_pool_bwd`` (the same file) as
          shipped and in each other tile of ``TRAIN_TILES`` (lanes and
          threads a block, steps a chunk forward and backward, blocks an
          SM, the next segment's loads in flight or not), and, with
          ``--against SOURCE``, the same entry points built from another
          qrnn_pool.cu (the one-thread-a-lane kernels of an earlier
          commit: ``git show <commit>:pase_tpu_torch/csrc/qrnn_pool.cu``):
          ms at the training shapes (``chip_smoke.TRAIN_QRNN_SHAPES``) in
          two passes (the second in reverse order), each output against
          the plain version of its own algebra;
  eval    ``qrnn_pool_fwd_eval`` (the same file) as shipped and in each
          other tile of ``EVAL_TILES`` (lanes and threads a block, steps a
          chunk, blocks an SM, segments of loads in flight): ms at the
          T = 200 shapes of ``chip_smoke.QRNN_SHAPES`` in two passes (the
          second in reverse order), max |h|, |c_T| error against the
          chunked plain version at each library's chunking and against
          the plain version, two calls bit for bit; then the shipped
          library's three unseeded entry points (``qrnn_pool_fwd_eval``,
          ``qrnn_pool_fwd_few``, ``qrnn_pool_fwd``) in turns at
          ``ROUTE_SHAPES``, where the route (``cuda_qrnn.forward_entry``)
          is drawn;
  split   ``qrnn_pool_fwd_split`` (the same file) as shipped and in each
          other tile of ``SPLIT_TILES`` (steps a chunk, blocks an SM, the
          tiles the tiling aims at, segments of loads in flight): at
          ``SPLIT_SHAPES``, max |h|, |c_T| error against the
          plain version of its algebra at each library's tiling and
          against the plain version, two calls bit for bit, ms in two
          passes (the second in reverse order); then the shipped library's
          unseeded entry points (``qrnn_pool_fwd_split``,
          ``qrnn_pool_fwd_few``, ``qrnn_pool_fwd_eval``) and an empty
          kernel (the launch floor) in turns there, where the route is
          drawn; where T is cut, the split and few-lane kernels again on
          gates whose carries decay slowly and not at all (its second
          run's worst case), with the share of segments that run takes;
          and the split and eval kernels in turns at the eval kernel's
          shapes;
  fewlane ``qrnn_pool_fwd_few`` (the same file) as shipped and in each
          other tile of ``FEW_TILES`` (lanes a block, warps a block, steps
          a chunk and blocks an SM of its narrow, mid and wide tiles,
          segments of loads in flight), with ``--against SOURCE`` beside
          the unseeded serving entry ``qrnn_pool_fwd_chunked`` built from
          another qrnn_pool.cu (the kernel the few-lane one replaced: ``git
          show <commit>:pase_tpu_torch/csrc/qrnn_pool.cu`` of an earlier
          commit), and the split and eval kernels, the streaming floor and
          an empty kernel, in turns at ``FEW_SHAPES`` on random, slow and
          frozen gates (``gates``): max |h|, |c_T| error against the plain
          version and the few-lane kernels' against the plain version of
          their algebra at each library's chunking, two calls bit for bit,
          ms in two passes (the second in reverse order); each library's
          registers, spills and blocks an SM; host us per eager call at
          [1,200,512] (each library's entry through ctypes, the wrapper,
          the operator).
Times are CUDA-event medians of CUDA graphs of 20 calls (no host time
between launches; a captured split call zeroes flags of its own, one memset
in the graph). Nothing here is on a path; the shipped kernels are chosen in
the sources.
"""

import concurrent.futures
import os
import statistics
import sys
import tempfile

import torch

from pase_tpu_torch import conv_proto
from pase_tpu_torch.ops import conv, cuda_build, cuda_qrnn
from pase_tpu_torch.ops import qrnn as plain
from pase_tpu_torch.precision import full_precision

VARIANT_DIR = os.path.join(cuda_build.BUILD_DIR, "variants")
_SEG_NAMES = ("kSegLanes", "kSegSteps", "kSegThreads")
SEG_SHIPPED = (8, 128, 128)
_TRAIN_NAMES = ("kTrainLanes", "kTrainThreads", "kFwdChunk", "kBwdChunk",
                "kFwdBlocks", "kBwdBlocks", "kPrefetch")
TRAIN_SHIPPED = (32, 256, 8, 4, 3, 3, "true")
_EVAL_NAMES = ("kEvalLanes", "kEvalThreads", "kEvalChunk", "kEvalBlocks",
               "kEvalDepth")
EVAL_SHIPPED = (32, 256, 5, 3, 1)
# the split kernel runs the eval kernel's tile (chunk, blocks an SM,
# depth) at kSplitGrid tiles a call
_SPLIT_NAMES = ("kEvalChunk", "kEvalBlocks", "kSplitGrid", "kEvalDepth")
SPLIT_SHIPPED = (5, 3, 384, 1)
_FEW_NAMES = ("kFewLanes", "kFewWarps", "kFewChunk", "kFewBlocks",
              "kFewMidLanes", "kFewMidWarps", "kFewMidChunk",
              "kFewMidBlocks", "kFewWideLanes", "kFewWideWarps",
              "kFewWideChunk", "kFewWideBlocks", "kFewDepth")
FEW_SHIPPED = (4, 16, 4, 2, 8, 16, 8, 1, 8, 16, 4, 2, 1)
# the unseeded serving entry of an earlier qrnn_pool.cu (--against)
AGAINST_ENTRY = "qrnn_pool_fwd_chunked"


def _tile_consts(names, shipped, tile):
    """Line replacements that set a kernel's tile constants ``names`` from
    their shipped values to ``tile``'s (a string value is a bool)."""
    def line(name, value):
        kind = "bool" if isinstance(value, str) else "int"
        return f"constexpr {kind} {name} = {value};"
    return [(line(k, old), line(k, new))
            for k, old, new in zip(names, shipped, tile) if old != new]


# name: (source, [(shipped line, replacement)])
VARIANTS = {
    "conv: no promotion": (conv.SOURCE, [
        ("            zero(acc);\n          }", "          }"),
        ("            promote(sum, acc);\n", ""),
        ("        copy(acc, sum);\n", "")]),
}
# the segmented kernel's tiles (lanes, steps, threads a block); the
# shipped one (SEG_SHIPPED) is built as shipped
SEG_TILES = [(4, 32, 128), (4, 64, 128), (4, 128, 128), (8, 32, 128),
             (8, 64, 128), (8, 128, 128), (32, 32, 128), (32, 64, 128),
             (32, 128, 128), (4, 64, 256), (4, 128, 256), (8, 128, 256)]
VARIANTS.update({
    "qrnn serial: {} lanes, {} steps, {} threads".format(*tile):
    (cuda_qrnn.SOURCE, _tile_consts(_SEG_NAMES, SEG_SHIPPED, tile))
    for tile in SEG_TILES if tile != SEG_SHIPPED})
# the training pair's tiles: (lanes, threads a block, forward and backward
# steps a chunk at most, forward and backward blocks an SM, prefetch); the
# shipped one (TRAIN_SHIPPED) is built as shipped
TRAIN_TILES = [TRAIN_SHIPPED, (32, 256, 8, 8, 3, 2, "true"),
               (32, 256, 8, 8, 3, 2, "false"), (32, 256, 4, 4, 4, 3, "true"),
               (32, 256, 16, 4, 2, 3, "true"), (32, 256, 8, 8, 4, 3, "true"),
               (32, 512, 8, 8, 1, 1, "true"), (32, 128, 8, 8, 6, 4, "true"),
               (64, 256, 8, 8, 3, 2, "true"), (32, 256, 8, 4, 3, 4, "true"),
               (32, 256, 8, 4, 3, 3, "false"), (32, 256, 8, 2, 3, 4, "true"),
               (32, 256, 8, 4, 2, 3, "true"), (32, 128, 8, 4, 6, 6, "true"),
               (64, 256, 8, 4, 3, 3, "true")]
VARIANTS.update({
    "qrnn train: {} lanes, {} threads, chunks {}/{}, blocks {}/{}, "
    "prefetch {}".format(*tile):
    (cuda_qrnn.SOURCE, _tile_consts(_TRAIN_NAMES, TRAIN_SHIPPED, tile))
    for tile in TRAIN_TILES if tile != TRAIN_SHIPPED})
# qrnn_pool_fwd_eval's tiles: (lanes, threads a block, steps a chunk at
# most, blocks an SM, segments of loads in flight); the shipped one
# (EVAL_SHIPPED) is built as shipped
EVAL_TILES = [(32, 256, 8, 3, 1), (32, 256, 8, 3, 0), (32, 256, 7, 3, 1),
              (32, 256, 5, 3, 1), (32, 256, 5, 4, 1), (32, 256, 5, 3, 2),
              (32, 256, 5, 4, 2), (32, 256, 4, 4, 1), (32, 256, 4, 3, 2),
              (32, 256, 4, 4, 2), (32, 256, 8, 2, 2), (32, 128, 5, 6, 1),
              (32, 128, 5, 8, 1), (32, 128, 5, 6, 2), (32, 128, 4, 8, 1),
              (32, 128, 4, 8, 2)]
VARIANTS.update({
    "qrnn eval: {} lanes, {} threads, chunk {}, blocks {}, "
    "depth {}".format(*tile):
    (cuda_qrnn.SOURCE, _tile_consts(_EVAL_NAMES, EVAL_SHIPPED, tile))
    for tile in EVAL_TILES if tile != EVAL_SHIPPED})
# qrnn_pool_fwd_split's tiles: (steps a chunk at most, blocks an SM, tiles
# the tiling aims at, segments of loads in flight); the shipped one
# (SPLIT_SHIPPED) is built as shipped
SPLIT_TILES = [SPLIT_SHIPPED, (5, 3, 264, 1), (5, 3, 528, 1),
               (5, 3, 768, 1), (5, 3, 192, 1), (5, 4, 384, 1),
               (5, 2, 384, 1), (5, 3, 384, 2), (8, 3, 384, 1),
               (4, 3, 384, 1), (5, 3, 1536, 1)]
VARIANTS.update({
    "qrnn split: chunk {}, blocks {}, grid {}, depth {}".format(*tile):
    (cuda_qrnn.SOURCE, _tile_consts(_SPLIT_NAMES, SPLIT_SHIPPED, tile))
    for tile in SPLIT_TILES if tile != SPLIT_SHIPPED})
# qrnn_pool_fwd_few's tiles: (lanes a block, warps a block, steps a chunk
# at most, blocks an SM) on at most kFewNarrow lanes, the same on at most
# kFewMid and on more, and segments of loads in flight; each other tile
# changes one of the three (the 15 other pairs of narrow and wide tiles of
# the first design were timed before, PERF.md); the shipped one
# (FEW_SHIPPED) is built as shipped
_N, _M, _W = FEW_SHIPPED[:4], FEW_SHIPPED[4:8], FEW_SHIPPED[8:12]
FEW_TILES = [FEW_SHIPPED] + [
    narrow + _M + _W + (1,) for narrow in ((4, 16, 2, 2), (8, 16, 4, 2))
] + [_N + mid + _W + (1,) for mid in ((8, 16, 4, 2), (8, 32, 4, 1))] + [
    _N + _M + wide + (1,) for wide in ((16, 16, 8, 1), (8, 16, 8, 1))]
VARIANTS.update({
    "qrnn fewlane: {} lanes, {} warps, chunk {}, blocks {}; mid {} lanes, "
    "{} warps, chunk {}, blocks {}; wide {} lanes, {} warps, chunk {}, "
    "blocks {}; depth {}".format(*tile):
    (cuda_qrnn.SOURCE, _tile_consts(_FEW_NAMES, FEW_SHIPPED, tile))
    for tile in FEW_TILES if tile != FEW_SHIPPED})
# B = 1 extraction from 1 s to 30 s, the time shard's [2,1500,512], the
# serving shapes (the batch of 8, TDNN's, 8 x 2 s, and 2048 to 6144 lanes
# between them, where the eval kernel's route begins), and the split
# kernel's [1,10000,512]
FEW_SHAPES = [(1, 100, 512), (1, 200, 512), (1, 500, 512), (1, 625, 512),
              (1, 800, 512), (1, 1000, 512), (1, 1500, 512),
              (1, 3000, 512), (2, 200, 512), (2, 1000, 512),
              (2, 1500, 512), (8, 1000, 512), (8, 4000, 512),
              (8, 1000, 256), (8, 200, 256), (4, 200, 512),
              (4, 1000, 512), (8, 200, 512), (8, 400, 512),
              (12, 1000, 512), (1, 10000, 512)]
# the shapes of the unseeded calls under 4096 lanes or over 200 steps at
# 4096 (the split and the few-lane kernels' side of the route): B = 1
# extraction (2 s, the contract's 625 frames, the rehearsal's 8 s,
# forward-chunk's 10 s window, 15 to 200 s files), the time shard's
# [2,1500,512], 2 to 8 rows of 200 to 10000 steps at H = 512 and 256
SPLIT_SHAPES = [(1, 200, 512), (1, 625, 512), (1, 800, 512), (1, 1000, 512),
                (1, 1500, 512), (1, 2000, 512), (1, 3000, 512),
                (1, 5000, 512), (1, 7500, 512), (1, 10000, 512),
                (1, 20000, 512), (2, 1500, 512), (2, 3000, 512),
                (2, 5000, 512), (2, 10000, 512), (4, 200, 512),
                (4, 1000, 512), (4, 2000, 512), (4, 3000, 512),
                (8, 1000, 256), (8, 2000, 256), (8, 4000, 256),
                (8, 400, 512), (8, 600, 512), (8, 800, 512),
                (8, 1000, 512), (8, 4000, 512)]
# the unseeded route's shapes: B x 200 at 2048 to 16384 lanes (H = 512
# and 256), 400 to 4000 steps at 4096 to 16384 lanes, the long serving
# windows, and 21 steps
ROUTE_SHAPES = [(4, 200, 512), (8, 200, 512), (12, 200, 512),
                (16, 200, 512), (20, 200, 512), (24, 200, 512),
                (32, 200, 512), (32, 200, 256), (48, 200, 256),
                (8, 400, 512), (8, 600, 512), (12, 400, 512),
                (12, 1000, 512),
                (8, 1000, 512), (16, 1000, 512), (24, 1000, 512),
                (32, 1000, 512), (8, 1000, 256), (16, 4000, 512),
                (8, 4000, 512), (1, 10000, 512), (8, 21, 512),
                (24, 21, 512), (48, 21, 512)]
# the streaming pushes (1 s and 100 ms at B = 1 and 8); one step, 16 x 10
# and 24 x 200 (the segmented kernel's side of the route), 32 x 100 and
# 48 x 200 (the loop's); the eval shape; a long stream
SERIAL_SHAPES = [(1, 100, 512), (8, 100, 512), (1, 10, 512), (8, 10, 512),
                 (1, 1, 512), (16, 10, 512), (32, 100, 512), (24, 200, 512),
                 (48, 200, 512), (96, 200, 512), (1, 1000, 512)]


def build_variants(names):
    """{name: library} of the named variants, one nvcc each, all started
    together."""
    with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as pool:
        jobs = {k: pool.submit(build_variant, k) for k in names}
        return {k: job.result() for k, job in jobs.items()}


def build_variant(name):
    """The variant's library (ctypes handle), built from the shipped
    source with its lines replaced; raises if a line is not found."""
    source, subs = VARIANTS[name]
    with open(source) as f:
        text = f.read()
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} is not one line of {source}")
        text = text.replace(old, new)
    os.makedirs(VARIANT_DIR, exist_ok=True)
    stem = "".join(c if c.isalnum() else "_" for c in name)
    path = os.path.join(VARIANT_DIR, f"{stem}.cu")
    # whole or not at all: another process may be compiling the same file
    fd, tmp = tempfile.mkstemp(suffix=".cu", dir=VARIANT_DIR)
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    argtypes = (conv._ARGTYPES if source == conv.SOURCE
                else cuda_qrnn._ARGTYPES)
    return cuda_build.load(path, argtypes, VARIANT_DIR)


def graph_ms(fn, batches=5, per_batch=20):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_batch):
            fn()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def _with_lib(module, lib, fn):
    """fn() with ``module``'s kernels taken from ``lib``."""
    attr = "_LIB"
    saved = getattr(module, attr)
    setattr(module, attr, lib)
    try:
        return fn()
    finally:
        setattr(module, attr, saved)


def conv_rows():
    libs = {"shipped": conv.build(),
            "no promotion": build_variant("conv: no promotion")}
    rows = []
    for layer, x, w in conv_proto.make_inputs(torch.float32, "cuda"):
        xs, ws, tout = conv.space_to_depth(x, w, layer[2])
        want = conv.conv_s1_plain(xs, ws)
        top = want.abs().max().item()
        for name, lib in libs.items():
            y = _with_lib(conv, lib, lambda: conv.conv_s1(xs, ws))
            err = (y - want).abs().max().item() / top
            ms = _with_lib(conv, lib, lambda: graph_ms(
                lambda: conv.conv_s1(xs, ws), per_batch=5))
            rows.append((layer, name, err, ms))
            print(f"[conv] {layer} float32 {name}: max|y - y_plain| / "
                  f"max|y_plain| {err:.3e}, {ms:.4f} ms", flush=True)
        del xs, ws, want, x, w
    return rows


SERIAL_LOOP = "qrnn_pool_fwd: one thread a lane"


def serial_rows():
    """qrnn_pool_fwd_seg as shipped and in its other tiles, and the
    one-thread-a-lane qrnn_pool_fwd, seeded, at SERIAL_SHAPES: ms in two
    passes (the second in reverse order), and whether each output equals
    the loop's bit for bit."""
    shipped = cuda_qrnn.build()
    libs = {"qrnn_pool_fwd_seg: {} lanes, {} steps, {} threads, "
            "shipped".format(*SEG_SHIPPED): shipped}
    libs.update(build_variants([k for k in VARIANTS
                                if k.startswith("qrnn serial")]))
    libs[SERIAL_LOOP] = shipped
    order = list(libs)
    rows = []
    for b, t, h in SERIAL_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(b * t)
        y = torch.randn(b, t, 3 * h, device="cuda", generator=gen)
        c0 = torch.randn(b, h, device="cuda", generator=gen)
        h_lane, c_lane = cuda_qrnn.qrnn_pool_fwd_loop(y, c0)
        h_ref, c_ref = plain.qrnn_pool(y, c0)
        err = max((h_lane - h_ref).abs().max().item(),
                  (c_lane - c_ref).abs().max().item())
        ms = {k: [] for k in order}
        same = {}
        for pas in (order, order[::-1]):
            for name in pas:
                def run(loop=name == SERIAL_LOOP):
                    return (cuda_qrnn.qrnn_pool_fwd_loop(y, c0) if loop
                            else cuda_qrnn.qrnn_pool_fwd_seg(y, c0))
                hk, ck = _with_lib(cuda_qrnn, libs[name], run)
                same[name] = bool(torch.equal(hk, h_lane)
                                  and torch.equal(ck, c_lane))
                ms[name].append(_with_lib(cuda_qrnn, libs[name],
                                         lambda: graph_ms(run)))
        for name in order:
            rows.append(((b, t, h), name, same[name], ms[name]))
            print(f"[serial] y[{b},{t},{3 * h}] seeded {name}: "
                  f"{statistics.mean(ms[name]):.5f} ms (passes "
                  f"{ms[name][0]:.5f}, {ms[name][1]:.5f}); equal to the "
                  f"one-thread-a-lane loop bit for bit: {same[name]}",
                  flush=True)
        print(f"[serial] y[{b},{t},{3 * h}]: the loop vs the plain version "
              f"max|d| {err:.2e}", flush=True)
        del y, c0
    return rows


def train_rows(against=None):
    """The training pair as shipped and in its other tiles (and from the
    ``against`` source) at chip_smoke.TRAIN_QRNN_SHAPES: fwd_train and bwd
    ms in two passes (the second in reverse order); max |h|, |c|, |c_T|,
    |dc0| error and max |dy| error / max(1, max |dy_plain|) against the
    chunked plain versions at each library's chunking (the serial ones for
    ``against``), seeded with c0 and dc_T."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import TRAIN_QRNN_SHAPES
    libs = {"shipped: {} lanes, {} threads, chunks {}/{}, blocks {}/{}, "
            "prefetch {}".format(*TRAIN_SHIPPED): cuda_qrnn.build()}
    libs.update(build_variants([k for k in VARIANTS
                                if k.startswith("qrnn train")]))
    if against:
        libs[f"against {against}"] = cuda_build.load(
            against, {k: cuda_qrnn._ARGTYPES[k] for k in
                      ("qrnn_pool_fwd_train", "qrnn_pool_bwd")},
            os.path.join(VARIANT_DIR, "against"))
    order = list(libs)
    rows = []
    for b, t, h in TRAIN_QRNN_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(b * t + h)
        y = torch.randn(b, t, 3 * h, device="cuda", generator=gen)
        c0, dct = (torch.randn(b, h, device="cuda", generator=gen)
                   for _ in range(2))
        dh = torch.randn(b, t, h, device="cuda", generator=gen)
        zeros = torch.zeros_like(dct)
        errs = {}

        def run():
            hk, ck, ctk = cuda_qrnn.qrnn_pool_fwd_train(y, c0)
            return (hk, ck, ctk) + cuda_qrnn.qrnn_pool_bwd(y, ck, dh, dct, c0)
        for name, lib in libs.items():
            hk, ck, ctk, dyk, dc0k = _with_lib(cuda_qrnn, lib, run)
            if name.startswith("against"):
                hp, cp = plain.qrnn_pool_fwd_train(y, c0)
                ctp = cp[:, -1]
                dyp, dc0p = plain.qrnn_pool_bwd(y, ck, dh, dct, c0)
            else:
                chunks, lf, lb = cuda_qrnn.train_chunking(t, lib)
                hp, cp, ctp = plain.qrnn_pool_fwd_train_chunked_plain(
                    y, c0, chunk=lf, chunks=chunks)
                dyp, dc0p = plain.qrnn_pool_bwd_chunked_plain(
                    y, ck, dh, dct, c0, chunk=lb, chunks=chunks)
            errs[name] = (max((hk - hp).abs().max().item(),
                              (ck - cp).abs().max().item(),
                              (ctk - ctp).abs().max().item(),
                              (dc0k - dc0p).abs().max().item()),
                          (dyk - dyp).abs().max().item()
                          / max(1.0, dyp.abs().max().item()))
        _, c, _ = _with_lib(cuda_qrnn, libs[order[0]],
                            lambda: cuda_qrnn.qrnn_pool_fwd_train(y))
        ms = {k: ([], []) for k in order}
        for pas in (order, order[::-1]):
            for name in pas:
                lib = libs[name]
                ms[name][0].append(_with_lib(cuda_qrnn, lib, lambda: graph_ms(
                    lambda: cuda_qrnn.qrnn_pool_fwd_train(y))))
                ms[name][1].append(_with_lib(cuda_qrnn, lib, lambda: graph_ms(
                    lambda: cuda_qrnn.qrnn_pool_bwd(y, c, dh, zeros))))
        for name in order:
            fwd, bwd = (statistics.mean(v) for v in ms[name])
            rows.append(((b, t, h), name, errs[name], fwd, bwd))
            print(f"[train] y[{b},{t},{3 * h}] {name}: fwd_train {fwd:.5f} "
                  f"ms (passes {ms[name][0][0]:.5f}, {ms[name][0][1]:.5f}), "
                  f"bwd {bwd:.5f} ms (passes {ms[name][1][0]:.5f}, "
                  f"{ms[name][1][1]:.5f}); max err fwd {errs[name][0]:.2e}, "
                  f"dy rel {errs[name][1]:.2e}", flush=True)
        del y, c0, dct, dh, c
    return rows


def eval_rows():
    """qrnn_pool_fwd_eval as shipped and in its other tiles at the T = 200
    shapes of chip_smoke.QRNN_SHAPES (ms in two passes, the second in
    reverse order; max |h|, |c_T| error against the chunked plain version
    at each library's chunking and against the plain version; two calls
    bit for bit), then the shipped unseeded entry points in turns at
    ROUTE_SHAPES."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import QRNN_SHAPES as SMOKE_SHAPES
    shipped = cuda_qrnn.build()
    libs = {"shipped: {} lanes, {} threads, chunk {}, blocks {}, "
            "depth {}".format(*EVAL_SHIPPED): shipped}
    libs.update(build_variants([k for k in VARIANTS
                                if k.startswith("qrnn eval")]))
    order = list(libs)
    rows = []
    for b, t, h in [s for s in SMOKE_SHAPES if s[1] == 200]:
        gen = torch.Generator(device="cuda").manual_seed(b * t + h)
        y = torch.randn(b, t, 3 * h, device="cuda", generator=gen)
        h_ref, c_ref = plain.qrnn_pool(y)
        errs, same = {}, {}

        def run():
            return cuda_qrnn.qrnn_pool_fwd_eval(y)
        for name, lib in libs.items():
            hk, ck = _with_lib(cuda_qrnn, lib, run)
            hk2, ck2 = _with_lib(cuda_qrnn, lib, run)
            chunks, steps = cuda_qrnn.eval_chunking(t, lib)
            hp, _, cp = plain.qrnn_pool_fwd_train_chunked_plain(
                y, chunk=steps, chunks=chunks)
            errs[name] = (max((hk - hp).abs().max().item(),
                              (ck - cp).abs().max().item()),
                          max((hk - h_ref).abs().max().item(),
                              (ck - c_ref).abs().max().item()))
            same[name] = bool(torch.equal(hk, hk2) and torch.equal(ck, ck2))
        ms = {k: [] for k in order}
        for pas in (order, order[::-1]):
            for name in pas:
                ms[name].append(_with_lib(cuda_qrnn, libs[name],
                                         lambda: graph_ms(run)))
        for name in order:
            rows.append(((b, t, h), name, errs[name], same[name], ms[name]))
            print(f"[eval] y[{b},{t},{3 * h}] {name}: "
                  f"{statistics.mean(ms[name]):.5f} ms (passes "
                  f"{ms[name][0]:.5f}, {ms[name][1]:.5f}); max err vs its "
                  f"chunked plain {errs[name][0]:.2e}, vs plain "
                  f"{errs[name][1]:.2e}; two calls bit for bit "
                  f"{same[name]}", flush=True)
        del y, h_ref, c_ref
    entries = {"eval": cuda_qrnn.qrnn_pool_fwd_eval,
               "few": cuda_qrnn.qrnn_pool_fwd_few,
               "loop": cuda_qrnn.qrnn_pool_fwd_loop}
    for b, t, h in ROUTE_SHAPES:
        y = torch.randn(b, t, 3 * h, device="cuda")
        ms = {k: [] for k in entries}
        for pas in (list(entries), list(entries)[::-1]):
            for name in pas:
                ms[name].append(graph_ms(lambda: entries[name](y)))
        mean = {k: statistics.mean(v) for k, v in ms.items()}
        rows.append(((b, t, h), "route", mean))
        print(f"[eval route] y[{b},{t},{3 * h}] ({b * h} lanes): "
              + ", ".join(f"{k} {v:.5f} ms" for k, v in mean.items())
              + f" (in turns, mean of two); fastest "
              f"{min(mean, key=mean.get)}; routed to "
              f"{cuda_qrnn.forward_entry(b * h, False, t)}", flush=True)
        del y
    return rows


def rerun_share(y):
    """The share of the split kernel's segments that its second run takes
    on y, as the plain version of its algebra rounds: in each time tile
    but the first, the segments up to the first one (i) before which the
    product of the a is under 1e-9 in every lane of a TILE_LANES-lane tile
    (the speculative run stores h from there) and (ii) whose carry in, run
    from the tile's carry in, equals the one run from 0 bit for bit in
    every lane of the tile (the kernel's tests; the carry in is the last
    tile's carry out, run from its own)."""
    b, t, h3 = y.shape
    hid = h3 // 3
    chunk, tile = plain.split_tiling(b * hid, t)
    if tile >= t:
        return 0.0
    seg = plain.EVAL_CHUNKS * chunk
    a = 1.0 - torch.sigmoid(torch.chunk(y, 3, dim=-1)[1])
    lanes = b * hid
    pad = -lanes % plain.TILE_LANES

    def by_tile(x):
        """[B, segs, H] -> [segs, lane tiles]: every lane of a tile."""
        x = x.permute(1, 0, 2).reshape(x.shape[1], lanes)
        return torch.nn.functional.pad(x, (0, pad), value=True).reshape(
            x.shape[0], -1, plain.TILE_LANES).all(-1)
    carry, again, total = None, 0.0, 0
    for t0 in range(0, t, tile):
        n = min(tile, t - t0)
        part = y[:, t0:t0 + n]
        _, c_true, c_last = plain.qrnn_pool_fwd_train_chunked_plain(
            part, carry, chunk=chunk, chunks=plain.EVAL_CHUNKS)
        segs = -(-n // seg)
        total += segs
        if t0 > 0:
            _, c_spec, _ = plain.qrnn_pool_fwd_train_chunked_plain(
                part, chunk=chunk, chunks=plain.EVAL_CHUNKS)
            # the carry into segment g: the seed at g = 0, else c at g seg - 1
            ends = [g * seg - 1 for g in range(1, segs)]
            meet = torch.ones(b, segs, hid, dtype=torch.bool,
                              device=y.device)
            meet[:, 0] = carry == 0
            if ends:
                meet[:, 1:] = c_true[:, ends] == c_spec[:, ends]
            # the product of the a before segment g: chunks', in order
            ca = torch.nn.functional.pad(
                a[:, t0:t0 + n], (0, 0, 0, segs * seg - n), value=1.0
            ).reshape(b, segs * plain.EVAL_CHUNKS, chunk, hid).prod(2)
            before = torch.ones(b, segs, hid, device=y.device)
            prod = torch.ones(b, hid, device=y.device)
            for g in range(segs):
                before[:, g] = prod
                for m in range(plain.EVAL_CHUNKS):
                    prod = prod * ca[:, g * plain.EVAL_CHUNKS + m]
            tiny = by_tile(before < 1e-9)
            stop = by_tile(meet) & (tiny.cumsum(0) > 0)
            idx = torch.arange(segs, device=y.device)[:, None]
            first = torch.where(stop, idx, segs).min(0).values
            again += first.float().mean().item()
        carry = c_last
    return again / total


def gates(y, kind):
    """y with its f third as ``kind`` has it: "randn" as drawn; "slow": 6
    less (a = 1 - f about 0.9975, a carry lives thousands of steps);
    "frozen": f = 0 exactly from the second step on (a = 1: a carry never
    decays, so a run from 0 never meets the run from the true one)."""
    hid = y.shape[-1] // 3
    y = y.clone()
    if kind == "slow":
        y[..., hid:2 * hid] -= 6.0
    elif kind == "frozen":
        y[:, 1:, hid:2 * hid] = -200.0
    return y


# the eval kernel's shapes (6144 to 49152 lanes of T = 200, and 21 steps),
# where the split kernel runs its body at one or two time tiles
EVAL_MATCH_SHAPES = [(12, 200, 512), (24, 200, 512), (48, 200, 512),
                     (96, 200, 512), (48, 200, 256), (48, 21, 512)]


def split_rows():
    """qrnn_pool_fwd_split as shipped and in its other tiles at
    SPLIT_SHAPES (max |h|, |c_T| error against the plain version of its
    algebra at each library's tiling and against the plain version; two
    calls bit for bit; ms in two passes, the second in reverse order),
    then the shipped unseeded entry points and the empty kernel in turns
    there; where the split kernel cuts T, the split and few-lane kernels in
    turns on gates that decay slowly or not at all (``gates``), with the
    share of segments its second run takes (``rerun_share``); and the
    split and eval kernels in turns at EVAL_MATCH_SHAPES."""
    shipped = cuda_qrnn.build()
    libs = {"shipped: chunk {}, blocks {}, grid {}, depth {}".format(
        *SPLIT_SHIPPED): shipped}
    libs.update(build_variants([k for k in VARIANTS
                                if k.startswith("qrnn split")]))
    order = list(libs)
    entries = {"split": cuda_qrnn.qrnn_pool_fwd_split,
               "few": cuda_qrnn.qrnn_pool_fwd_few,
               "eval": cuda_qrnn.qrnn_pool_fwd_eval}
    rows = []
    for b, t, h in SPLIT_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(b * t + h)
        y = torch.randn(b, t, 3 * h, device="cuda", generator=gen)
        h_ref, c_ref = plain.qrnn_pool(y)
        errs, same = {}, {}

        def run():
            return cuda_qrnn.qrnn_pool_fwd_split(y)
        for name, lib in libs.items():
            hk, ck = _with_lib(cuda_qrnn, lib, run)
            hk2, ck2 = _with_lib(cuda_qrnn, lib, run)
            chunk, tile, _ = cuda_qrnn.split_tiling(b * h, t, lib)
            hp, cp = plain.qrnn_pool_split_plain(y, tile=tile, chunk=chunk)
            errs[name] = (max((hk - hp).abs().max().item(),
                              (ck - cp).abs().max().item()),
                          max((hk - h_ref).abs().max().item(),
                              (ck - c_ref).abs().max().item()))
            same[name] = bool(torch.equal(hk, hk2) and torch.equal(ck, ck2))
        ms = {k: [] for k in order}
        for pas in (order, order[::-1]):
            for name in pas:
                ms[name].append(_with_lib(cuda_qrnn, libs[name],
                                         lambda: graph_ms(run)))
        for name in order:
            tiling = cuda_qrnn.split_tiling(b * h, t, libs[name])
            rows.append(((b, t, h), name, errs[name], same[name], ms[name]))
            print(f"[split] y[{b},{t},{3 * h}] {name} (tiles {tiling[2]} of "
                  f"{tiling[1]} steps, chunks of {tiling[0]}): "
                  f"{statistics.mean(ms[name]):.5f} ms (passes "
                  f"{ms[name][0]:.5f}, {ms[name][1]:.5f}); max err vs its "
                  f"algebra {errs[name][0]:.2e}, vs plain "
                  f"{errs[name][1]:.2e}; two calls bit for bit "
                  f"{same[name]}", flush=True)
        fns = {k: (lambda f=f: f(y)) for k, f in entries.items()}
        fns["empty"] = cuda_qrnn.empty_launch
        turns = {k: [] for k in fns}
        for pas in (list(fns), list(fns)[::-1]):
            for name in pas:
                turns[name].append(graph_ms(fns[name]))
        mean = {k: statistics.mean(v) for k, v in turns.items()}
        rows.append(((b, t, h), "route", mean))
        print(f"[split route] y[{b},{t},{3 * h}] ({b * h} lanes): "
              + ", ".join(f"{k} {v:.5f} ms" for k, v in mean.items())
              + f" (in turns, mean of two); bound "
              f"{16 * b * t * h / 3.35e9:.5f} ms (bytes); routed to "
              f"{cuda_qrnn.forward_entry(b * h, False, t)}", flush=True)
        if plain.split_tiling(b * h, t)[1] < t:
            for kind in ("randn", "slow", "frozen"):
                yk = gates(y, kind)
                turns = {"split": [], "few": []}
                for pas in (list(turns), list(turns)[::-1]):
                    for name in pas:
                        turns[name].append(
                            graph_ms(lambda f=entries[name]: f(yk)))
                mean = {k: statistics.mean(v) for k, v in turns.items()}
                share = rerun_share(yk)
                rows.append(((b, t, h), f"gates {kind}", mean, share))
                print(f"[split gates] y[{b},{t},{3 * h}] {kind}: split "
                      f"{mean['split']:.5f} ms, few "
                      f"{mean['few']:.5f} ms (in turns, mean of two), "
                      f"split / few {mean['split'] / mean['few']:.3f}"
                      f"; segments run again {share:.1%} (the plain "
                      f"algebra's)", flush=True)
                del yk
        del y, h_ref, c_ref
    for b, t, h in EVAL_MATCH_SHAPES:
        y = torch.randn(b, t, 3 * h, device="cuda")
        turns = {"split": [], "eval": []}
        for pas in (list(turns), list(turns)[::-1]):
            for name in pas:
                turns[name].append(graph_ms(lambda f=entries[name]: f(y)))
        mean = {k: statistics.mean(v) for k, v in turns.items()}
        chunk, tile, tiles = cuda_qrnn.split_tiling(b * h, t)
        rows.append(((b, t, h), "eval match", mean))
        print(f"[split eval] y[{b},{t},{3 * h}] ({b * h} lanes; split: "
              f"{tiles} tiles of {tile} steps): split {mean['split']:.5f} "
              f"ms, eval {mean['eval']:.5f} ms (in turns, mean of two), "
              f"split / eval {mean['split'] / mean['eval']:.3f}", flush=True)
        del y
    return rows


def few_libs(against=None):
    """{name: library} of the fewlane group: the shipped one, every other
    tile of FEW_TILES and, with ``against``, AGAINST_ENTRY built from that
    source."""
    libs = {"shipped: {} lanes, {} warps, chunk {}, blocks {}; mid {} "
            "lanes, {} warps, chunk {}, blocks {}; wide {} lanes, {} warps, "
            "chunk {}, blocks {}; depth {}".format(*FEW_SHIPPED):
            cuda_qrnn.build()}
    libs.update(build_variants([k for k in VARIANTS
                                if k.startswith("qrnn fewlane")]))
    if against:
        libs[f"against {against}"] = cuda_build.load(
            against, {AGAINST_ENTRY: cuda_qrnn._ARGTYPES["qrnn_pool_fwd_few"]},
            os.path.join(VARIANT_DIR, "against"))
    return libs


def _entry(name):
    """The unseeded forward entry a fewlane library is timed by."""
    return AGAINST_ENTRY if name.startswith("against") else "qrnn_pool_fwd_few"


def _call(lib, entry, y):
    """(h, c_T) of ``lib``'s forward entry ``entry`` on y, unseeded, on the
    current stream (not counted: on no path)."""
    b, t, h3 = y.shape
    h = torch.empty(b, t, h3 // 3, device=y.device)
    c = torch.empty(b, h3 // 3, device=y.device)
    err = getattr(lib, entry)(y.data_ptr(), None, h.data_ptr(), c.data_ptr(),
                              b, t, h3 // 3,
                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return h, c


def few_turns(y, libs, extra=None):
    """{name: [ms of two passes in turns]} on y of each library's entry
    (``_entry``) and of ``extra`` ({name: fn}), in CUDA graphs."""
    fns = {name: (lambda lib=lib, e=_entry(name): graph_ms(
        lambda: _call(lib, e, y))) for name, lib in libs.items()}
    for name, fn in (extra or {}).items():
        fns[name] = (lambda fn=fn: graph_ms(fn))
    ms = {k: [] for k in fns}
    for pas in (list(fns), list(fns)[::-1]):
        for name in pas:
            ms[name].append(fns[name]())
    return ms


def _host_us(fn, calls=300):
    """Host us per unsynchronized call, after a warm-up call."""
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def few_host_us(libs):
    """Host us per eager call at [1,200,512], median of 6 samples of 300
    calls in turns: the shipped library's and ``against``'s entries through
    ctypes (arguments built in Python), the wrapper qrnn_pool_fwd_few and
    the operator."""
    y = torch.randn(1, 200, 3 * 512, device="cuda")
    h, c = torch.empty(1, 200, 512, device="cuda"), torch.empty(
        1, 512, device="cuda")

    def args():
        return (y.data_ptr(), None, h.data_ptr(), c.data_ptr(), 1, 200, 512,
                torch.cuda.current_stream().cuda_stream)
    order = list(libs)
    timers = {f"{name}, its entry": (lambda lib=libs[name], e=_entry(name):
                                     _host_us(lambda: getattr(lib, e)(
                                         *args())))
              for name in order
              if name == order[0] or name.startswith("against")}
    timers["shipped, the wrapper"] = lambda: _host_us(
        lambda: cuda_qrnn.qrnn_pool_fwd_few(y))
    timers["shipped, the operator"] = lambda: _host_us(
        lambda: cuda_qrnn.qrnn_pool_fwd(y))
    samples = {k: [] for k in timers}
    for _ in range(3):
        for name in list(timers) + list(timers)[::-1]:
            samples[name].append(timers[name]())
    return {k: statistics.median(v) for k, v in samples.items()}


def fewlane_rows(against=None):
    """qrnn_pool_fwd_few as shipped and in its other tiles (and
    ``against``'s entry), the split and eval kernels, the streaming floor
    and an empty kernel in turns at FEW_SHAPES on random, slow and frozen
    gates, with each output's error against the plain version (and the
    few-lane kernels' against their algebra) and two calls bit for bit;
    each library's registers; host us per eager call at [1,200,512]."""
    libs = few_libs(against)
    order = list(libs)
    old = next((k for k in order if k.startswith("against")), None)
    rows = []
    for name, lib in libs.items():
        if name != old:
            attrs = cuda_qrnn.few_attrs(lib)
            rows.append((name, "attrs", attrs))
            print(f"[fewlane] {name}: {attrs}", flush=True)
    host = few_host_us(libs)
    rows.append(((1, 200, 512), "host us", host))
    print("[fewlane host] y[1,200,1536] host us per eager call, median of "
          "6 samples of 300 calls in turns: " + "; ".join(
              f"{k} {v:.2f}" for k, v in host.items()), flush=True)
    for b, t, hid in FEW_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(b * t + hid)
        base = torch.randn(b, t, 3 * hid, device="cuda", generator=gen)
        bound_ms = (16 * b * t * hid + 4 * b * hid) / 3.35e9
        for kind in ("randn", "slow", "frozen"):
            y = gates(base, kind)
            h_ref, c_ref = plain.qrnn_pool(y)
            errs, same = {}, {}
            for name, lib in libs.items():
                hk, ck = _call(lib, _entry(name), y)
                hk2, ck2 = _call(lib, _entry(name), y)
                alg = float("nan")
                if name != old:
                    _, per, warps, steps = cuda_qrnn.few_chunking(
                        b * hid, t, lib)
                    hp, _, cp = plain.qrnn_pool_fwd_train_chunked_plain(
                        y, chunk=steps, chunks=per * warps, warp_chunks=per)
                    alg = max((hk - hp).abs().max().item(),
                              (ck - cp).abs().max().item())
                errs[name] = (max((hk - h_ref).abs().max().item(),
                                  (ck - c_ref).abs().max().item()), alg)
                same[name] = bool(torch.equal(hk, hk2)
                                  and torch.equal(ck, ck2))
            extra = {"split": lambda: cuda_qrnn.qrnn_pool_fwd_split(y),
                     "eval": lambda: cuda_qrnn.qrnn_pool_fwd_eval(y),
                     "empty": cuda_qrnn.empty_launch}
            if hid % 4 == 0:
                extra["stream floor"] = lambda: cuda_qrnn.stream_floor(y)
            ms = few_turns(y, libs, extra)
            mean = {k: statistics.mean(v) for k, v in ms.items()}
            rows.append(((b, t, hid), kind, errs, same, ms))
            for name in order:
                print(f"[fewlane] y[{b},{t},{3 * hid}] {kind} {name}: "
                      f"{mean[name]:.5f} ms (passes {ms[name][0]:.5f}, "
                      f"{ms[name][1]:.5f}); max err vs plain "
                      f"{errs[name][0]:.2e}, vs its algebra "
                      f"{errs[name][1]:.2e}; two calls bit for bit "
                      f"{same[name]}", flush=True)
            best = min((k for k in order if k != old), key=mean.get)
            vs_old = (f"against {mean[old]:.5f}, shipped / against "
                      f"{mean[order[0]] / mean[old]:.3f}, " if old else "")
            print(f"[fewlane turns] y[{b},{t},{3 * hid}] {kind} ({b * hid} "
                  f"lanes): shipped {mean[order[0]]:.5f} ms, {vs_old}split "
                  f"{mean['split']:.5f}, eval {mean['eval']:.5f}, stream "
                  f"floor {mean.get('stream floor', float('nan')):.5f}, "
                  f"empty {mean['empty']:.5f}; bound {bound_ms:.5f} ms "
                  f"(bytes); fastest tile {best} {mean[best]:.5f}; routed "
                  f"to {cuda_qrnn.forward_entry(b * hid, False, t)}",
                  flush=True)
            del y, h_ref, c_ref
        del base
    return rows


GROUPS = {"conv": conv_rows, "serial": serial_rows,
          "train": train_rows, "eval": eval_rows, "split": split_rows,
          "fewlane": fewlane_rows}


def main():
    args = sys.argv[1:]
    against = None
    if "--against" in args:
        i = args.index("--against")
        against = os.path.abspath(args[i + 1])
        args = args[:i] + args[i + 2:]
    groups = args or list(GROUPS)
    unknown = [g for g in groups if g not in GROUPS]
    if unknown:
        raise SystemExit(f"unknown group(s) {unknown}; of {list(GROUPS)}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "False)")
    full_precision()
    print(torch.cuda.get_device_name(0), flush=True)
    return {g: GROUPS[g](against) if g in ("train", "fewlane")
            else GROUPS[g]() for g in groups}


if __name__ == "__main__":
    main()
