"""The design choices of three kernels, measured against the variants
they were chosen over, on the card.

    python -m pase_tpu_torch.kernel_variants [conv] [qrnn] [serial]

(no group named: all three). Each variant is a copy of the shipped source
with a few lines replaced (``VARIANTS``), built like the shipped kernels
into ``build/pase_tpu_torch/variants/`` (all at once) and called through
its own library:
  conv    ``conv_s1_tf32x3`` (csrc/conv_s1_tc.cu) with and without the
          promotion of each window's partial sums into float32 sums: max
          |y - y_plain| / max|y_plain| and ms at the seven trunk layers in
          float32 (``conv_proto.LAYERS``, B = 96);
  qrnn    ``qrnn_pool_fwd_chunked`` (csrc/qrnn_pool.cu) with other chunk
          lengths, blocks per SM and o loads in flight, and with its lanes
          per block fixed at 8 or at 4 instead of chosen by the SM count:
          ms at the serving shapes;
  serial  ``qrnn_pool_fwd_seg`` (the same file), seeded, as shipped and
          in each other tile of ``SEG_TILES`` (lanes, steps per segment
          and threads a block), and the one-thread-a-lane
          ``qrnn_pool_fwd``: ms at the streaming push shapes, around the
          route's limit and at the eval shape (``SERIAL_SHAPES``), in two
          passes (the second in reverse order), each output equal to the
          loop's bit for bit.
Times are CUDA-event medians of CUDA graphs of 20 calls (no host time
between launches). Nothing here is on a path; the shipped kernels are
chosen in the sources.
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

VARIANT_DIR = os.path.join(cuda_build.BUILD_DIR, "variants")
_CHUNK = ("constexpr int kMaxChunk = 8;", "constexpr int kChunkBlocks = 2;",
          "constexpr int kOLoads = 8;")
_LANES = "  const int lanes = (B * H + 7) / 8 >= sms ? 8 : 4;"
_SEG_NAMES = ("kSegLanes", "kSegSteps", "kSegThreads")
SEG_SHIPPED = (8, 128, 128)


def _seg_consts(*tile):
    """Line replacements for a tile (lanes, steps, threads) of the
    segmented kernel."""
    return [(f"constexpr int {k} = {old};", f"constexpr int {k} = {new};")
            for k, old, new in zip(_SEG_NAMES, SEG_SHIPPED, tile)
            if old != new]


def _chunk_consts(steps, blocks, loads):
    return [(_CHUNK[0], f"constexpr int kMaxChunk = {steps};"),
            (_CHUNK[1], f"constexpr int kChunkBlocks = {blocks};"),
            (_CHUNK[2], f"constexpr int kOLoads = {loads};")]


# name: (source, [(shipped line, replacement)])
VARIANTS = {
    "conv: no promotion": (conv.SOURCE, [
        ("            zero(acc);\n          }", "          }"),
        ("            promote(sum, acc);\n", ""),
        ("        copy(acc, sum);\n", "")]),
    "qrnn: 16 steps, 1 block/SM, 16 o loads": (cuda_qrnn.SOURCE,
                                               _chunk_consts(16, 1, 16)),
    "qrnn: 16 steps, 2 blocks/SM, 8 o loads": (cuda_qrnn.SOURCE,
                                               _chunk_consts(16, 2, 8)),
    "qrnn: 16 steps, 2 blocks/SM, 16 o loads": (cuda_qrnn.SOURCE,
                                                _chunk_consts(16, 2, 16)),
    "qrnn: 8 steps, 3 blocks/SM, 8 o loads": (cuda_qrnn.SOURCE,
                                              _chunk_consts(8, 3, 8)),
    "qrnn: always 8 lanes a block": (cuda_qrnn.SOURCE, [
        (_LANES, "  const int lanes = 8;")]),
    "qrnn: always 4 lanes a block": (cuda_qrnn.SOURCE, [
        (_LANES, "  const int lanes = 4;")]),
}
# the segmented kernel's tiles (lanes, steps, threads a block); the
# shipped one (SEG_SHIPPED) is built as shipped
SEG_TILES = [(4, 32, 128), (4, 64, 128), (4, 128, 128), (8, 32, 128),
             (8, 64, 128), (8, 128, 128), (32, 32, 128), (32, 64, 128),
             (32, 128, 128), (4, 64, 256), (4, 128, 256), (8, 128, 256)]
VARIANTS.update({
    "qrnn serial: {} lanes, {} steps, {} threads".format(*tile):
    (cuda_qrnn.SOURCE, _seg_consts(*tile))
    for tile in SEG_TILES if tile != SEG_SHIPPED})
QRNN_SHAPES = [(8, 1000, 512), (1, 1000, 512), (24, 200, 512),
               (1, 10000, 512), (8, 4000, 512)]
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


def qrnn_rows():
    libs = {"shipped: 8 steps, 2 blocks/SM, 8 o loads, lanes by SMs":
            cuda_qrnn.build()}
    libs.update(build_variants([k for k in VARIANTS
                                if k.startswith("qrnn:")]))
    rows = []
    for b, t, h in QRNN_SHAPES:
        y = torch.randn(b, t, 3 * h, device="cuda")
        h_ref, c_ref = plain.qrnn_pool(y)
        for name, lib in libs.items():
            def run():
                return cuda_qrnn.qrnn_pool_fwd_chunked(y)
            hk, ck = _with_lib(cuda_qrnn, lib, run)
            err = max((hk - h_ref).abs().max().item(),
                      (ck - c_ref).abs().max().item())
            ms = _with_lib(cuda_qrnn, lib, lambda: graph_ms(run))
            rows.append(((b, t, h), name, err, ms))
            print(f"[qrnn] y[{b},{t},{3 * h}] {name}: max err {err:.2e}, "
                  f"{ms:.4f} ms", flush=True)
        del y
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


GROUPS = {"conv": conv_rows, "qrnn": qrnn_rows, "serial": serial_rows}


def main():
    groups = sys.argv[1:] or list(GROUPS)
    unknown = [g for g in groups if g not in GROUPS]
    if unknown:
        raise SystemExit(f"unknown group(s) {unknown}; of {list(GROUPS)}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    return {g: GROUPS[g]() for g in groups}


if __name__ == "__main__":
    main()
