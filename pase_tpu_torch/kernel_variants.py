"""The design choices of two kernels, measured against the variants they
were chosen over, on the card.

    python -m pase_tpu_torch.kernel_variants

Each variant is a copy of the shipped source with a few lines replaced
(``VARIANTS``), built like the shipped kernels into
``build/pase_tpu_torch/variants/`` and called through its own library:
  conv    ``conv_s1_tf32x3`` (csrc/conv_s1_tc.cu) with and without the
          promotion of each window's partial sums into float32 sums: max
          |y - y_plain| / max|y_plain| and ms at the seven trunk layers in
          float32 (``conv_proto.LAYERS``, B = 96);
  qrnn    ``qrnn_pool_fwd_chunked`` (csrc/qrnn_pool.cu) with other chunk
          lengths, blocks per SM and o loads in flight, and with its lanes
          per block fixed at 8 or at 4 instead of chosen by the SM count:
          ms at the serving shapes.
Times are CUDA-event medians of CUDA graphs of 20 calls (no host time
between launches). Nothing here is on a path; the shipped kernels are
chosen in the sources.
"""

import os
import statistics

import torch

from pase_tpu_torch import conv_proto
from pase_tpu_torch.ops import conv, cuda_build, cuda_qrnn
from pase_tpu_torch.ops import qrnn as plain

VARIANT_DIR = os.path.join(cuda_build.BUILD_DIR, "variants")
_CHUNK = ("constexpr int kMaxChunk = 8;", "constexpr int kChunkBlocks = 2;",
          "constexpr int kOLoads = 8;")
_LANES = "  const int lanes = (B * H + 7) / 8 >= sms ? 8 : 4;"


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
QRNN_SHAPES = [(8, 1000, 512), (1, 1000, 512), (24, 200, 512),
               (1, 10000, 512), (8, 4000, 512)]


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
    with open(path, "w") as f:
        f.write(text)
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
    libs.update({k: build_variant(k) for k in VARIANTS
                 if k.startswith("qrnn")})
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


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    return conv_rows(), qrnn_rows()


if __name__ == "__main__":
    main()
