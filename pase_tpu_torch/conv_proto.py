"""The stride-1 conv kernels (``ops/conv.py``: the entry points
``conv_s1_tc`` for bf16 and ``conv_s1_tf32x3`` for float32 of
``csrc/conv_s1_tc.cu``) at the PASE+ trunk's conv shapes, against their
plain version and cuDNN.

    python -m pase_tpu_torch.conv_proto [--device cuda]

The port of the benchmark loop of ``experiments/pallas_conv_proto.py``:
the seven layers (T, K, stride, Cin, Cout) of ``LAYERS`` at batch 96, x [96,
T + K - 1, Cin] and w [K, Cin, Cout] x 0.05 drawn on the device from a
seeded ``torch.Generator``, strided layers through the space-to-depth
reform (bf16 from the command line; ``chip_smoke.py`` also runs float32).
``forward`` runs each layer once through ``conv_strided`` (one kernel
launch per layer: ``conv_s1_tc`` in bf16, ``conv_s1_tf32x3`` in float32);
``measure`` then gives, per layer: max|y - y_plain| and its share of
max|y_plain|, the kernel's time, the plain version's, cuDNN's
(``F.conv1d`` on NCW / OIW copies made before the timed region, TF32 off),
all in CUDA-event ms, and the bound: the larger of the bytes (x and w read
once, y written once) at 3.35 TB/s and the operations at the dtype's dense
peak on the tensor cores, the H100 SXM's published rates: 989 TFLOP/s
bf16; for float32 three TF32 products at 495 TFLOP/s, 165 TFLOP/s of
float32 work (the float32-accurate method on the tensor cores). Beside it
for float32, ``old_bound_ms``: the same with 67 TFLOP/s, the CUDA cores'
float32 peak, the bound of earlier measurements. TFLOP/s count the layer's
own operations, not the taps the reform pads.
"""

import argparse
import statistics

import torch
import torch.nn.functional as F

from pase_tpu_torch.ops import conv
from pase_tpu_torch.precision import full_precision

B = 96
LAYERS = [
    (32000, 20, 10, 64, 64),
    (3200, 11, 2, 64, 128),
    (1600, 11, 1, 128, 128),
    (1600, 11, 2, 128, 256),
    (800, 11, 1, 256, 256),
    (800, 11, 2, 256, 512),
    (400, 11, 2, 512, 512),
]
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
CUDA_CORE_F32_OPS_PER_S = 67e12


def make_inputs(dtype=torch.bfloat16, device="cuda", layers=LAYERS, batch=B,
                seed=0):
    """[(layer, x [batch, T + K - 1, Cin] in dtype, w [K, Cin, Cout]
    float32)] drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for layer in layers:
        t, k, _, cin, cout = layer
        x = torch.randn((batch, t + k - 1, cin), generator=gen,
                        device=device).to(dtype)
        w = torch.randn((k, cin, cout), generator=gen, device=device) * 0.05
        out.append((layer, x, w))
    return out


def forward(inputs):
    """Each layer once through the kernel: [y [batch, Tout, Cout]]."""
    return [conv.conv_strided(x, w, layer[2]) for layer, x, w in inputs]


def _cuda_ms(fn, batches=3, per_batch=5):
    """Median over batches of the CUDA-event time per call, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def bound(layer, x, batch=B, peak=None):
    """(least ms for the layer's conv on the card, what bounds it), with
    the operations at ``peak`` FLOP/s (default: x's type's)."""
    t, k, s, cin, cout = layer
    tout = (x.shape[1] - k) // s + 1
    esize = x.element_size()
    nbytes = x.numel() * esize + k * cin * cout * 4 + batch * tout * cout \
        * esize
    nops = 2 * batch * tout * k * cin * cout
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / (peak or PEAK_OPS_PER_S[x.dtype])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def measure(inputs, ys):
    """Per layer: the kernel's output ``ys`` against the plain version, and
    the times of the kernel, the plain version and cuDNN. These launches
    are not the ``forward`` run's: read ``conv.LAUNCHES`` before calling
    this."""
    rows = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for (layer, x, w), y in zip(inputs, ys):
            rows.append(_measure_layer(layer, x, w, y))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return rows


def _measure_layer(layer, x, w, y):
    t, k, s, cin, cout = layer
    xs, ws, tout = conv.space_to_depth(x, w, s)
    plain = conv.conv_s1_plain(xs, ws)[:, :tout]
    err = (y.float() - plain.float()).abs().max().item()
    top = plain.float().abs().max().item()
    ws_x = ws.to(x.dtype).contiguous()
    x_ncw = x.transpose(1, 2).contiguous()
    w_oiw = w.to(x.dtype).permute(2, 1, 0).contiguous()
    lib = F.conv1d(x_ncw, w_oiw, stride=s).transpose(1, 2)
    lib_err = (lib.float() - plain.float()).abs().max().item()
    ms = _cuda_ms(lambda: conv.conv_s1(xs, ws_x))
    strided_ms = _cuda_ms(lambda: conv.conv_strided(x, w, s))
    plain_ms = _cuda_ms(lambda: conv.conv_s1_plain(xs, ws_x))
    library_ms = _cuda_ms(lambda: F.conv1d(x_ncw, w_oiw, stride=s))
    bound_ms, bound_by = bound(layer, x, x.shape[0])
    old = (bound(layer, x, x.shape[0], CUDA_CORE_F32_OPS_PER_S)
           if x.dtype == torch.float32 else (None, None))
    row = {"layer": list(layer), "dtype": str(x.dtype),
           "max_abs_err": err, "max_abs_plain": top,
           "library_err": lib_err, "ms": ms, "strided_ms": strided_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "old_bound_ms": old[0], "old_bound_by": old[1],
           "gflop": 2 * x.shape[0] * tout * k * cin * cout / 1e9}
    del plain, lib, x_ncw, w_oiw, xs, ws, ws_x
    return row


def _rate(r, ms):
    """TFLOP/s and share of the bound of a call that took ``ms``."""
    return f"{r['gflop'] / ms:.1f} TFLOP/s, {r['bound_ms'] / ms:.1%} of bound"


def format_row(r):
    t, k, s, cin, cout = r["layer"]
    return (f"k={k:<2d} s={s:<2d} {cin:>3d}->{cout:<3d} T={t:<5d} "
            f"max|y - y_plain| {r['max_abs_err']:.3e} "
            f"({r['max_abs_err'] / r['max_abs_plain']:.2e} of max|y_plain|),"
            f" cuDNN {r['library_err']:.3e}; kernel {r['ms']:.4f} ms "
            f"({_rate(r, r['ms'])}; + reform {r['strided_ms']:.4f}), "
            f"cuDNN {r['library_ms']:.4f} ms ({_rate(r, r['library_ms'])}), "
            f"plain {r['plain_ms']:.3f} ms ({_rate(r, r['plain_ms'])}); "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})" + _old(r))


def _old(r):
    """The float32 bound at the CUDA cores' peak, beside the new one."""
    if r.get("old_bound_ms") is None:
        return ""
    return (f"; at 67 TFLOP/s (CUDA cores) {r['old_bound_ms']:.4f} ms "
            f"({r['old_bound_by']})")


def format_total(rows):
    keys = ["ms", "plain_ms", "library_ms", "bound_ms", "gflop"]
    old = all(r.get("old_bound_ms") is not None for r in rows)
    tot = {k: sum(r[k] for r in rows)
           for k in keys + (["old_bound_ms"] if old else [])}
    return (f"{tot['gflop']:.1f} GFLOP: kernel {tot['ms']:.4f} ms "
            f"({_rate(tot, tot['ms'])}), cuDNN {tot['library_ms']:.4f} ms "
            f"({_rate(tot, tot['library_ms'])}), plain "
            f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms"
            + (f" (at 67 TFLOP/s {tot['old_bound_ms']:.4f} ms)" if old
               else ""))


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m pase_tpu_torch.conv_proto")
    p.add_argument("--device", default="cuda", choices=("cuda",))
    opts = p.parse_args(argv)
    full_precision()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "False)")
    print(f"{torch.cuda.get_device_name(0)}; B={B}, bfloat16")
    inputs = make_inputs(torch.bfloat16, opts.device)
    rows = measure(inputs, forward(inputs))
    for r in rows:
        print(format_row(r))
    print("TOTAL " + format_total(rows))
    return rows


if __name__ == "__main__":
    main()
