"""QRNN (quasi-recurrent) pooling, plain PyTorch.

Window-2 QRNN semantics (torchqrnn, as wired by the reference
build_rnn_block):

  source_t = [x_t, x_{t-1}]            (x_{-1} = 0)
  (z, f, o) = split(W @ source_t + b)  (3 * hidden)
  z = tanh(z); f = sigmoid(f)
  c_t = f_t * z_t + (1 - f_t) * c_{t-1}     (ForgetMult)
  h_t = sigmoid(o_t) * c_t

These are the plain versions of the CUDA kernels in ``ops/cuda_qrnn.py``:
the CPU path of the encoder and the reference the kernels are held to on
the card (``qrnn_pool_few_plain`` repeats the few-lane kernel's algebra,
``qrnn_pool_split_plain`` the split one's,
``qrnn_pool_serial_plain`` the seeded chain of the serial ones,
``qrnn_pool_fwd_train_chunked_plain`` and ``qrnn_pool_bwd_chunked_plain``
the training pair's, for tests).
``forget_mult`` steps sequentially over T in the JAX package's
algebra (a = 1-f, b = f*z, c0 folded into b_1); ``qrnn_pool_bwd`` is the
reverse-time scan of its gradient (the VJP of
``pase_tpu/ops/pallas_qrnn.py``), with the gate derivatives applied.
"""

import torch
import torch.nn.functional as F


def forget_mult(f, z, c0=None):
    """ForgetMult: c_t = f_t * z_t + (1 - f_t) * c_{t-1}.

    Args:
      f, z: [B, T, H] gates/candidates.
      c0: optional [B, H] initial state.
    Returns: c [B, T, H].
    """
    a = 1.0 - f
    b = f * z
    if c0 is not None:
        # fold the initial state into the first step: c_1 = a_1*c0 + b_1
        b = torch.cat([(b[:, 0] + a[:, 0] * c0)[:, None], b[:, 1:]], dim=1)
    c = torch.zeros_like(b[:, 0])
    cs = []
    for t in range(b.shape[1]):
        c = a[:, t] * c + b[:, t]
        cs.append(c)
    return torch.stack(cs, dim=1)


def qrnn_pool_fwd_train(y, c0=None):
    """QRNN pooling that also returns every state: y [B, T, 3H] (+ c0
    [B, H]) -> (h [B, T, H], c [B, T, H]). c is the residual that
    ``qrnn_pool_bwd`` needs."""
    z, f, o = torch.chunk(y, 3, dim=-1)
    c = forget_mult(torch.sigmoid(f), torch.tanh(z), c0=c0)
    return torch.sigmoid(o) * c, c


def qrnn_pool(y, c0=None):
    """Full window-2 QRNN pooling given pre-activation gates.

    Args:
      y: [B, T, 3H] linear output over [x_t, x_{t-1}].
      c0: optional [B, H] initial state.
    Returns: (h [B, T, H], c_T [B, H]).
    """
    h, c = qrnn_pool_fwd_train(y, c0)
    return h, c[:, -1]


# the training kernels' chunks a segment and steps a chunk at most, forward
# and backward (kTrainChunks, kFwdChunk, kBwdChunk of csrc/qrnn_pool.cu)
TRAIN_CHUNKS, FWD_CHUNK, BWD_CHUNK = 8, 8, 4


def train_chunk_len(t, chunks=TRAIN_CHUNKS, max_chunk=FWD_CHUNK):
    """Steps a chunk of the training kernels for T = t: the fewest
    segments of ``chunks`` chunks of at most ``max_chunk`` steps, then the
    shortest chunk that covers T in as many (``train_len`` of
    csrc/qrnn_pool.cu)."""
    cover = -(-t // (chunks * max_chunk)) * chunks
    return -(-t // cover)


# qrnn_pool_fwd_eval's chunks a segment and steps a chunk at most
# (kEvalThreads / kEvalLanes and kEvalChunk of csrc/qrnn_pool.cu)
EVAL_CHUNKS, EVAL_CHUNK = 8, 5


def eval_chunk_len(t):
    """Steps a chunk of ``qrnn_pool_fwd_eval``'s kernel for T = t
    (``train_chunk_len`` at its chunks and chunk length)."""
    return train_chunk_len(t, EVAL_CHUNKS, EVAL_CHUNK)


# qrnn_pool_fwd_few's tiles (kFew* of csrc/qrnn_pool.cu): on at most
# FEW_NARROW lanes (lanes a block, warps a block, steps a chunk at most),
# on at most FEW_MID the mid tile's, on more the wide tile's
FEW_NARROW, FEW_MID = 512, 1024
FEW_TILE, FEW_MID_TILE, FEW_WIDE_TILE = (4, 16, 4), (8, 16, 8), (8, 16, 4)


def few_tile(lanes, t):
    """``qrnn_pool_fwd_few``'s tile for a call on ``lanes`` lanes (B * H) of
    T = t steps (``few_tile`` of csrc/qrnn_pool.cu): (lanes a block, chunks
    a warp, warps a block, steps a chunk). The narrow tile on at most
    FEW_NARROW lanes, the mid one on at most FEW_MID, else the wide one;
    32 / lanes chunks a warp; the chunk ``train_chunk_len`` at the block's
    chunks and the tile's chunk length."""
    lw, warps, max_chunk = (FEW_TILE if lanes <= FEW_NARROW else
                            FEW_MID_TILE if lanes <= FEW_MID else
                            FEW_WIDE_TILE)
    per = 32 // lw
    return lw, per, warps, train_chunk_len(t, per * warps, max_chunk)


def qrnn_pool_few_plain(y, c0=None):
    """The few-lane forward's algebra (``qrnn_pool_fwd_few``) at the
    shipped kernel's tile for y's lanes (``few_tile``), for tests and the
    wrapper's CPU path: ``qrnn_pool_fwd_train_chunked_plain`` with its
    chunks a warp x warps chunks of its chunk length, its chunks a warp as
    ``warp_chunks``. Returns (h [B, T, H], c_T [B, H])."""
    bsz, t, h3 = y.shape
    _, per, warps, chunk = few_tile(bsz * (h3 // 3), t)
    h, _, c_last = qrnn_pool_fwd_train_chunked_plain(
        y, c0, chunk=chunk, chunks=per * warps, warp_chunks=per)
    return h, c_last


# qrnn_pool_fwd_split's lanes a tile (kEvalLanes of csrc/qrnn_pool.cu; its
# chunks are the eval kernel's), segments a time tile at most and the
# blocks its tiling aims at (kSplitSegs, kSplitGrid)
TILE_LANES = 32
SPLIT_SEGS, SPLIT_GRID = 64, 384


def split_tiling(lanes, t):
    """``qrnn_pool_fwd_split``'s tiling of a call on ``lanes`` lanes (B * H)
    of T = t steps (``split_tiling`` of csrc/qrnn_pool.cu): (steps a chunk,
    steps a time tile). As many time tiles as bring the blocks (tiles of
    TILE_LANES lanes) to SPLIT_GRID, each of the fewest whole segments of
    EVAL_CHUNKS x EVAL_CHUNK steps (at most SPLIT_SEGS) that hold its share
    of t; when one tile holds t, the shortest chunk that covers t in as
    many."""
    seg = EVAL_CHUNKS * EVAL_CHUNK
    want = max(1, -(-SPLIT_GRID // -(-lanes // TILE_LANES)))
    segs = min(SPLIT_SEGS, max(1, -(-(-(-t // want)) // seg)))
    chunks = segs * EVAL_CHUNKS
    chunk = -(-t // chunks) if t <= chunks * EVAL_CHUNK else EVAL_CHUNK
    return chunk, chunks * chunk


def qrnn_pool_split_plain(y, c0=None, tile=None, chunk=None):
    """The split forward's algebra (``qrnn_pool_fwd_split``), for tests and
    the wrapper's CPU path: the same function as ``qrnn_pool``. T is cut
    into time tiles of ``tile`` steps, each run as
    ``qrnn_pool_fwd_train_chunked_plain`` runs a call (segments of
    EVAL_CHUNKS chunks of ``chunk`` steps). Tile i runs from its carry in;
    its map c -> A c + B is A, the product of its a (each chunk's a in
    order, then the chunks' products in order, as the kernel multiplies
    them), and B, the carry out of the run from c = 0. The carry into
    tile 0 is the seed (c0 or 0), into tile 1 the carry out of tile 0's
    run, into tile i + 1 A_i c_i + B_i, rounded once. ``tile`` None: the shipped kernel's
    tiling (``split_tiling``). Returns (h [B, T, H], c_T [B, H])."""
    bsz, t, h3 = y.shape
    if tile is None:
        chunk, tile = split_tiling(bsz * (h3 // 3), t)
    f = torch.sigmoid(torch.chunk(y, 3, dim=-1)[1])
    a = 1.0 - f
    carry = torch.zeros_like(a[:, 0]) if c0 is None else c0
    hs = []
    for t0 in range(0, t, tile):
        n = min(tile, t - t0)
        part = y[:, t0:t0 + n]
        h, _, c_last = qrnn_pool_fwd_train_chunked_plain(
            part, carry, chunk=chunk, chunks=EVAL_CHUNKS)
        hs.append(h)
        if t0 + n == t:
            break
        if t0 == 0:
            carry = c_last
            continue
        # A: each chunk's product of its a, the chunks' in order
        aa = _segment(a, t0, n, n, n // chunk, 1.0)
        ca = torch.ones_like(aa[:, :, 0])
        for u in range(chunk):
            ca = ca * aa[:, :, u]
        ma = torch.ones_like(carry)
        for k in range(ca.shape[1]):
            ma = ma * ca[:, k]
        mb = qrnn_pool_fwd_train_chunked_plain(
            part, chunk=chunk, chunks=EVAL_CHUNKS)[2]
        carry = _fma(ma, carry, mb)
    return torch.cat(hs, dim=1), c_last


def _fma(a, c, b):
    """a c + b rounded once to float32, as the kernels' fmaf: the product
    of two float32 is exact in float64, so only the float64 sum rounds
    before the float32 (twice: unlike fmaf only where the float64 sum
    lies on a float32 rounding boundary)."""
    return (a.double() * c.double() + b.double()).float()


def _segment(x, s0, n, seg, chunks, pad):
    """Steps s0 .. s0 + n of x [B, T, H] padded with ``pad`` to a segment
    of seg steps, as [B, chunks, seg // chunks, H]."""
    bsz, _, hid = x.shape
    part = F.pad(x[:, s0:s0 + n], (0, 0, 0, seg - n), value=pad)
    return part.reshape(bsz, chunks, seg // chunks, hid)


def qrnn_pool_fwd_train_chunked_plain(y, c0=None, chunk=None,
                                      chunks=TRAIN_CHUNKS, warp_chunks=1):
    """The chunked training forward's algebra (``qrnn_pool_fwd_train``),
    for tests: the same function as ``qrnn_pool_fwd_train``. T is walked in
    segments of ``chunks`` chunks of ``chunk`` steps: (1) every chunk's map
    c -> A c + B from c = 0 (B = a B + b, A = A a, steps in order); (2) the
    carry into chunk k, the segment's carry put through the maps of chunks
    0 .. k-1 one after the other; (3) each chunk re-run from its carry; the
    next segment's carry is the last step's c. Every a x + b is rounded
    once, as the kernels' fmaf (``_fma``). Steps past T are the
    identity (a = 1, b = 0). ``chunk`` None: the shipped kernel's
    (``train_chunk_len``). With ``warp_chunks`` > 1 (``qrnn_pool_fwd_few``'s
    algebra) (2) composes the maps as that kernel's warps do
    (``_warp_carries``; with 1 it is the fold above). Returns (h [B, T, H],
    c [B, T, H], c_T [B, H])."""
    yz, yf, yo = torch.chunk(y, 3, dim=-1)
    f = torch.sigmoid(yf)
    a, b, s = 1.0 - f, f * torch.tanh(yz), torch.sigmoid(yo)
    t = a.shape[1]
    chunk = chunk or train_chunk_len(t, chunks, FWD_CHUNK)
    carry = torch.zeros_like(a[:, 0]) if c0 is None else c0
    seg = chunk * chunks
    parts = []
    for s0 in range(0, t, seg):
        n = min(seg, t - s0)
        aa = _segment(a, s0, n, seg, chunks, 1.0)
        bb = _segment(b, s0, n, seg, chunks, 0.0)
        ma, mb = torch.ones_like(aa[:, :, 0]), torch.zeros_like(aa[:, :, 0])
        for u in range(chunk):
            mb = _fma(aa[:, :, u], mb, bb[:, :, u])
            ma = ma * aa[:, :, u]
        c = _warp_carries(ma, mb, carry, warp_chunks)
        cs = []
        for u in range(chunk):
            c = _fma(aa[:, :, u], c, bb[:, :, u])
            cs.append(c)
        c = torch.stack(cs, dim=2).reshape(a.shape[0], seg, -1)[:, :n]
        parts.append(c)
        carry = c[:, -1]
    c = torch.cat(parts, dim=1)
    return s * c, c, c[:, -1]


def _warp_carries(ma, mb, carry, per_warp):
    """The carry into each chunk of a segment (maps ma, mb [B, chunks, H],
    the segment's carry [B, H]) as ``qrnn_pool_fwd_few``'s kernel composes
    it, a warp holding ``per_warp`` consecutive chunks: (1) an inclusive
    scan of each warp's maps over its chunks (Hillis-Steele: at offsets 1,
    2, ..., chunk k >= off takes (A_k A_{k-off}, A_k B_{k-off} + B_k),
    rounded once, all at once); (2) the carry into warp w, the segment's
    carry put through the scanned maps of warps 0 .. w-1 (their last
    chunk's) one after the other; (3) into chunk k > 0 of a warp, the
    warp's carry put through the scanned map of its chunk k - 1. With one
    chunk a warp only (2) is left: the carry put through the maps of the
    chunks before each one after the other. Returns [B, chunks, H]."""
    bsz, nc, hid = ma.shape
    pa = ma.reshape(bsz, nc // per_warp, per_warp, hid)
    pb = mb.reshape(bsz, nc // per_warp, per_warp, hid)
    off = 1
    while off < per_warp:
        na, nb = pa.clone(), pb.clone()
        nb[:, :, off:] = _fma(pa[:, :, off:], pb[:, :, :-off], pb[:, :, off:])
        na[:, :, off:] = pa[:, :, off:] * pa[:, :, :-off]
        pa, pb, off = na, nb, 2 * off
    cw, c = [], carry
    for w in range(pa.shape[1]):
        cw.append(c)
        c = _fma(pa[:, w, -1], c, pb[:, w, -1])
    cw = torch.stack(cw, dim=1)[:, :, None]
    cin = cw.expand(-1, -1, per_warp, -1).clone()
    cin[:, :, 1:] = _fma(pa[:, :, :-1], cw, pb[:, :, :-1])
    return cin.reshape(bsz, nc, hid)


def qrnn_pool_bwd_chunked_plain(y, c, dh, dc_last=None, c0=None, chunk=None,
                                chunks=TRAIN_CHUNKS):
    """The chunked training backward's algebra (``qrnn_pool_bwd``), for
    tests: the same function as ``qrnn_pool_bwd``. The carry is q_t = a_t
    g_t, the gradient into c_{t-1} (q_T = dc_T, dc0 = q_0), and g_t = dh_t
    s_t + a_{t+1} g_{t+1} inside a chunk. Segments of ``chunks`` chunks of
    ``chunk`` steps from the last to the first: (1) every chunk's map q_in
    -> A q_in + B from q_in = 0, its steps walked down; (2) the carry into
    chunk k, the segment's carry put through the maps of the chunks after
    it, the last first; (3) each chunk re-run from its carry, g seeded with
    q_in and a_next with 1. The gate factors: dy_z = g (f (1 - z^2)), dy_f
    = g ((z - c_{t-1}) f a), dy_o = dh c s (1 - s). ``chunk`` None: the
    shipped kernel's. Returns (dy [B, T, 3H], dc0 [B, H] or None when c0 is
    None)."""
    yz, yf, yo = torch.chunk(y, 3, dim=-1)
    z, f, s = torch.tanh(yz), torch.sigmoid(yf), torch.sigmoid(yo)
    a = 1.0 - f
    first = torch.zeros_like(c[:, 0]) if c0 is None else c0
    c_prev = torch.cat([first[:, None], c[:, :-1]], dim=1)
    ds = dh * s
    t = a.shape[1]
    chunk = chunk or train_chunk_len(t, chunks, BWD_CHUNK)
    q = torch.zeros_like(c[:, 0]) if dc_last is None else dc_last
    seg = chunk * chunks
    g_all = torch.empty_like(c)
    for s0 in range((t - 1) // seg * seg, -1, -seg):
        n = min(seg, t - s0)
        aa = _segment(a, s0, n, seg, chunks, 1.0)
        dd = _segment(ds, s0, n, seg, chunks, 0.0)
        ma, g = torch.ones_like(aa[:, :, 0]), torch.zeros_like(aa[:, :, 0])
        an = torch.ones_like(ma)
        for u in range(chunk - 1, -1, -1):
            g = an * g + dd[:, :, u]
            an = aa[:, :, u]
            ma = ma * aa[:, :, u]
        mb = an * g
        qin = [None] * chunks
        for k in range(chunks - 1, -1, -1):
            qin[k] = q
            q = ma[:, k] * q + mb[:, k]
        g, an = torch.stack(qin, dim=1), torch.ones_like(ma)
        gs = [None] * chunk
        for u in range(chunk - 1, -1, -1):
            g = an * g + dd[:, :, u]
            gs[u] = g
            an = aa[:, :, u]
        g_all[:, s0:s0 + n] = torch.stack(gs, dim=2).reshape(
            a.shape[0], seg, -1)[:, :n]
        q = (an * g)[:, 0]
    dy = torch.cat([g_all * (f * (1.0 - z * z)),
                    g_all * ((z - c_prev) * f * a),
                    dh * c * s * (1.0 - s)], dim=-1)
    return dy, (None if c0 is None else q)


def qrnn_pool_serial_plain(y, c0=None):
    """The seeded serial plain version of the serial serving kernels
    (``qrnn_pool_fwd_seg`` and ``qrnn_pool_fwd``), for tests: the same
    function as ``qrnn_pool``. The gates of every step first (a = 1 -
    sigmoid(f), b = sigmoid(f) tanh(z), s = sigmoid(o)); then one chain per
    lane, c = a c + b, SEEDED with c0 (or 0) rather than folding c0 into
    b_1; h = s c. The kernels round a c + b once (fmaf), this twice, so it
    is within rounding of them, not bit for bit. Returns (h [B, T, H], c_T
    [B, H])."""
    yz, yf, yo = torch.chunk(y, 3, dim=-1)
    f = torch.sigmoid(yf)
    a, b, s = 1.0 - f, f * torch.tanh(yz), torch.sigmoid(yo)
    c = torch.zeros_like(a[:, 0]) if c0 is None else c0
    cs = []
    for u in range(y.shape[1]):
        c = a[:, u] * c + b[:, u]
        cs.append(c)
    c = torch.stack(cs, dim=1)
    return s * c, c[:, -1]


def qrnn_pool_bwd(y, c, dh, dc_last=None, c0=None):
    """Gradient of ``qrnn_pool`` by a reverse loop over T.

    With a = 1 - f and s = sigmoid(o):
      g_t  = dh_t s_t + a_{t+1} g_{t+1}      (g_{T-1} also takes dc_T)
      dy_z = g f (1 - z^2);  dy_f = g (z - c_{t-1}) f (1 - f)
      dy_o = dh c s (1 - s); dc0 = a_0 g_0   (c_{-1} = c0 or 0)

    Args:
      y: [B, T, 3H] pre-activation gates; c: [B, T, H] forward states;
      dh: [B, T, H]; dc_last: optional [B, H] gradient of c_T;
      c0: optional [B, H] initial state.
    Returns: (dy [B, T, 3H], dc0 [B, H] or None when c0 is None).
    """
    yz, yf, yo = torch.chunk(y, 3, dim=-1)
    z, f, s = torch.tanh(yz), torch.sigmoid(yf), torch.sigmoid(yo)
    a = 1.0 - f
    first = torch.zeros_like(c[:, 0]) if c0 is None else c0
    c_prev = torch.cat([first[:, None], c[:, :-1]], dim=1)
    g = torch.zeros_like(c[:, 0]) if dc_last is None else dc_last
    a_next = torch.ones_like(a[:, 0])
    gs = []
    for t in range(y.shape[1] - 1, -1, -1):
        g = dh[:, t] * s[:, t] + a_next * g
        gs.append(g)
        a_next = a[:, t]
    g = torch.stack(gs[::-1], dim=1)
    dy = torch.cat([g * f * (1.0 - z * z), g * (z - c_prev) * f * a,
                    dh * c * s * (1.0 - s)], dim=-1)
    return dy, (None if c0 is None else a[:, 0] * g[:, 0])


def shift_right(x, dim=1):
    """x_{t-1} with zero at t=0 (torchqrnn window-2 'Xm1') along ``dim``."""
    dim = dim % x.dim()
    pad = [0, 0] * (x.dim() - dim - 1) + [1, 0]
    return F.pad(x, pad).narrow(dim, 0, x.shape[dim])
