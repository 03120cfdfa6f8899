"""The tile routines' quantized stage, the parts a CPU can check.

K4 / K5 (``csrc/paged_tile.cuh``) and K6 (``csrc/paged_prefill_tile.cuh``)
read int8 / fp8 e4m3 pages on the tensor cores for bf16 and fp16 q at
head_dim 64 and 128; the CUDA code runs only on the card
(``test_torch_kernels_cuda.py``).  Here:

* the path rule over q type x pool type x head_dim;
* the byte conversions the kernels use (int8 through fp16's and fp32's
  magic numbers, e4m3 through fp16, bf16 as an fp32's top half), modelled
  bit for bit in numpy: every one of the 256 int8 codes and every finite
  e4m3 code comes out exact in bf16 and in fp16;
* a model of the stage arithmetic in fp32: 64-token stages anchored at
  multiples of 64, four 16-token warp chunks each with its own online
  softmax state merged at the end, each 8-token group's page (a group
  outside the walk reads the page past the pool's end: zeros, scale 0),
  S's column times its token's K scale, P's column times its V scale
  with l summing the unscaled P.  It is held to the JAX package's Pallas
  kernels in interpret mode over the same ``QuantPagedKV`` pools on the
  tile routines' layouts (the ragged ticks K4 groups, K6's chunk layouts,
  K5's decode rows), at page 8 and 16 (8 or 4 pages a stage), within
  ``QTOL`` (1e-5, fp32: the Pallas kernels' dequantized pages against
  scales applied per column).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from megatron_llm_tpu.ops import kv_quant as jax_kvq
from megatron_llm_tpu.ops.pallas.paged_attention import (
    paged_decode_kernel as pallas_decode,
    paged_prefill_kernel as pallas_prefill,
    paged_ragged_kernel as pallas_ragged,
)
from megatron_llm_tpu_torch.ops import kernels as pt_kernels
from megatron_llm_tpu_torch.weights import kv_pool_from_jax_numpy
from test_torch_kernels_cuda import (
    PREFILL_LAYOUTS,
    RAGGED_LAYOUTS,
    prefill_layout,
    ragged_layout,
)

QTOL = 1e-5
D = 64
SPAN, CH, BOX = 64, 16, 8     # a stage's tokens, a warp's, a group's
NEG_INF = -1e30
KV_TORCH = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


# ---------------------------------------------------------------------------
# the path rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_quantized_pools_path_rule(dtype, kv_dtype, d):
    """bf16 / fp16 q over int8 / fp8 pools at head_dim 64 and 128 take the
    tile routines; fp32 q and head_dim 256 keep ``attend_row``; the pool's
    storage type never changes the answer."""
    want = "tile" if dtype != torch.float32 and d in (64, 128) else "rows"
    assert pt_kernels.paged_path(dtype, d, KV_TORCH[kv_dtype]) == want
    assert pt_kernels.paged_path(dtype, d, dtype) == want
    assert pt_kernels.paged_path(dtype, d) == want


# ---------------------------------------------------------------------------
# the byte conversions (paged_tile.cuh: widen4), bit for bit
# ---------------------------------------------------------------------------


def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm`` on uint32 arrays: result byte n is byte
    ``sel``'s nibble n of the 8 bytes (x's 0-3, y's 4-7)."""
    x = np.asarray(x, np.uint64)
    y = np.asarray(y, np.uint64)
    both = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for n in range(4):
        k = (sel >> (4 * n)) & 7
        out |= ((both >> np.uint64(8 * k)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def _halves(words):
    """uint32 words -> their (low, high) 16-bit halves, low first."""
    words = np.asarray(words, np.uint32)
    return np.stack([words & 0xFFFF, words >> 16], -1).astype(np.uint16)


def _widen4(words, storage, target):
    """The kernels' conversion of four one-byte values (a word) to four
    values of ``target`` (bf16 / fp16 bits, uint16), in numpy."""
    words = np.asarray(words, np.uint32)
    if storage == "int8":
        u = words ^ np.uint32(0x80808080)       # each byte b + 128
        if target == "fp16":                    # 1024 + u less 1152
            bias = np.float16(1152)
            out = []
            for sel in (0x4140, 0x4342):
                h = _halves(_byte_perm(u, 0x64646464, sel)).view(np.float16)
                out.append((h - bias).view(np.uint16))
            return np.concatenate(out, -1)
        f = [(_byte_perm(u, 0x4B000000, 0x7540 + i).view(np.float32)
              - np.float32(8388736.0)).view(np.uint32) for i in range(4)]
        return np.concatenate([_halves(_byte_perm(f[0], f[1], 0x7632)),
                               _halves(_byte_perm(f[2], f[3], 0x7632))], -1)
    # e4m3: the hardware's conversion to fp16 (exact; torch's cast), then
    # bf16 as the top half of the fp32 value
    raw = words.view(np.uint8).reshape(*words.shape, 4)
    vals = torch.from_numpy(raw.copy()).view(torch.float8_e4m3fn)
    h = vals.to(torch.float16).numpy()
    if target == "fp16":
        return h.view(np.uint16)
    f32 = h.astype(np.float32).view(np.uint32)
    pairs = [_byte_perm(f32[..., 2 * i], f32[..., 2 * i + 1], 0x7632)
             for i in range(2)]
    return np.concatenate([_halves(p) for p in pairs], -1)


def _codes(storage):
    """Every code of the storage type as bytes, and its value: the 256 int8
    codes; the e4m3 codes but NaN (0x7F, 0xFF)."""
    b = np.arange(256, dtype=np.uint8)
    if storage == "int8":
        return b, b.view(np.int8).astype(np.float64)
    b = b[(b & 0x7F) != 0x7F]
    return b, b.view(ml_dtypes.float8_e4m3fn).astype(np.float64)


@pytest.mark.parametrize("target", ["bf16", "fp16"])
@pytest.mark.parametrize("storage", ["int8", "fp8"])
def test_every_code_converts_exactly(storage, target):
    """Every one-byte code, converted four to a word as the kernels do,
    is its exact value in bf16 and in fp16 (which is why the products can
    stay in q's type): 256 int8 codes, 254 finite e4m3 codes."""
    b, want = _codes(storage)
    pad = (-len(b)) % 4
    words = np.concatenate([b, b[:pad]]).view(np.uint32)
    got = _widen4(words, storage, target).reshape(-1)[:len(b)]
    as_float = (got.view(np.float16).astype(np.float64) if target == "fp16"
                else (got.astype(np.uint32) << 16).view(np.float32)
                .astype(np.float64))
    np.testing.assert_array_equal(as_float, want)
    # and the same values round-trip through the type exactly
    t = torch.float16 if target == "fp16" else torch.bfloat16
    back = torch.from_numpy(want).to(t).double().numpy()
    np.testing.assert_array_equal(back, want)


def test_byte_pairs_interleave_into_b_fragments():
    """The V fragment's byte interleave (``__byte_perm`` 0x5140 / 0x7362)
    pairs byte c of two tokens' words, low token first."""
    x0, x1 = np.uint32(0x33221100), np.uint32(0x77665544)
    assert _byte_perm(x0, x1, 0x5140) == 0x55114400
    assert _byte_perm(x0, x1, 0x7362) == 0x77336622


# ---------------------------------------------------------------------------
# a model of the stage arithmetic, against the Pallas kernels
# ---------------------------------------------------------------------------


def _quant_pools(kp, vp, kv_dtype):
    """``((jax k, jax v), (port k, port v))``: quantized page by page by
    the JAX package, carried to the port byte for byte."""
    jk, jv = (jax_kvq.quantize_pages(jnp.asarray(p), kv_dtype)
              for p in (kp, vp))
    return (jk, jv), tuple(kv_pool_from_jax_numpy(np.asarray(p.q),
                                                  np.asarray(p.scale), "cpu")
                           for p in (jk, jv))


def _stage_model(pk, pv, page):
    """The tile routines' arithmetic for one (row, head) at a time, in fp32
    (:func:`_attend`): codes exact, scales per column, stages and warp
    chunks as the kernels walk them.  ``sentinel`` counts the groups that
    read the page past the pool's end."""
    return dict(kc=pk.q.float(), vc=pv.q.float(), ks=pk.scale, vs=pv.scale,
                page=page, sentinel=0)


def _group(model, table, tok0, lo, hi, h):
    """Codes [8, d] of K and V and their scales for the 8-token group at
    tok0 (``table`` a row of page ids): zeros and scale 0 outside the walk
    [lo, hi)."""
    kc, vc = model["kc"], model["vc"]
    if not (tok0 + BOX > lo and tok0 < hi):
        model["sentinel"] += 1
        z = torch.zeros(BOX, kc.shape[-1])
        return z, z, 0.0, 0.0
    pid = int(table[tok0 // model["page"]])
    off = tok0 % model["page"]
    return (kc[pid, off:off + BOX, h], vc[pid, off:off + BOX, h],
            float(model["ks"][pid, h]), float(model["vs"][pid, h]))


def _attend(model, q, table, h, lo, hi, pos, window, scale):
    """One (row, head) over the walk [lo, hi): q [d] fp32; the row sees
    tokens below hi and inside the window."""
    sl2 = np.float32(scale * np.log2(np.e))
    m = [NEG_INF] * 4
    l = [torch.tensor(0.0)] * 4
    o = [torch.zeros_like(q)] * 4
    if hi <= lo:
        return torch.zeros_like(q)
    for st in range(lo // SPAN, -(-hi // SPAN)):
        for w in range(4):
            c0 = st * SPAN + w * CH
            kk, vv, kss, vss = [], [], [], []
            for gi in range(2):
                k8, v8, ks, vs = _group(model, table, c0 + BOX * gi, lo, hi, h)
                kk.append(k8), vv.append(v8)
                kss += [ks] * BOX
                vss += [vs] * BOX
            k16, v16 = torch.cat(kk), torch.cat(vv)
            ks16 = torch.tensor(kss, dtype=torch.float32)
            vs16 = torch.tensor(vss, dtype=torch.float32)
            tok = torch.arange(c0, c0 + CH)
            ok = tok < hi
            if window:
                ok &= pos - tok < window
            sc = (k16 @ q) * (ks16 * sl2)          # S's columns x K scale
            v = torch.where(ok, sc, torch.tensor(NEG_INF))
            mn = max(m[w], float(v.max()))
            alpha = 1.0 if m[w] == mn else float(np.exp2(m[w] - mn))
            p = torch.where(v <= NEG_INF * 0.5, torch.tensor(0.0),
                            torch.exp2(v - mn))
            l[w] = l[w] * alpha + p.sum()              # unscaled P
            o[w] = o[w] * alpha + (p * vs16) @ v16      # P's columns x V scale
            m[w] = mn
    mx = max(m)
    f = [1.0 if mw == mx else float(np.exp2(mw - mx)) for mw in m]
    lsum = sum(fw * lw for fw, lw in zip(f, l))
    osum = sum(fw * ow for fw, ow in zip(f, o))
    return torch.zeros_like(q) if float(lsum) == 0 else osum / lsum


def _row_walk(pos, hor, W, page, window):
    """attend_row's walk [lo, hi) of one row (horizon None: never binds)."""
    lo = 0
    if window and pos - window + 1 > 0:
        lo = ((pos - window + 1) // page) * page
    hi = min(pos + 1, W * page)
    if hor is not None:
        hi = min(hi, -(-hor // page) * page)
    return lo, hi


def _model_rows(model, q, tables, idx, pos, hor, window, scale):
    """The model over ragged rows q [R, 1, n, d]: [R, 1, n, d]."""
    R, _, n, d = q.shape
    g = n // model["kc"].shape[2]
    out = torch.zeros(R, 1, n, d)
    for r in range(R):
        lo, hi = _row_walk(int(pos[r]), None if hor is None else int(hor[r]),
                           tables.shape[1], model["page"], window)
        for head in range(n):
            out[r, 0, head] = _attend(
                model, torch.from_numpy(q[r, 0, head]), tables[idx[r]],
                head // g, lo, hi, int(pos[r]), window, scale)
    return out.numpy()


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("layout", RAGGED_LAYOUTS)
def test_stage_model_matches_pallas_ragged(layout, kv_dtype, page):
    """K4's quantized stage, modelled in fp32, against the Pallas
    ``_ragged_kernel`` in interpret mode on the ticks the tile routine
    groups (g 4, a 9-token window on alternate layouts); dead rows exact
    zeros; the walks reach the page past the pool's end."""
    q, kp, vp, tables, idx, pos, hor, live = ragged_layout(layout, 4, D, page)
    (jk, jv), (pk, pv) = _quant_pools(kp, vp, kv_dtype)
    window = 9 if RAGGED_LAYOUTS.index(layout) % 2 else None
    scale = 1.0 / D ** 0.5
    model = _stage_model(pk, pv, page)
    ours = _model_rows(model, q, tables, idx, pos, hor, window, scale)
    interp = np.asarray(pallas_ragged(
        jnp.asarray(q), jk, jv, *(jnp.asarray(a) for a in
                                  (tables, idx, pos, hor)),
        scale=scale, sliding_window=window, interpret=True))
    np.testing.assert_allclose(ours, interp, atol=QTOL, rtol=QTOL)
    assert (ours[~live] == 0).all()
    assert model["sentinel"] > 0


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("layout", list(PREFILL_LAYOUTS))
def test_stage_model_matches_pallas_prefill(layout, kv_dtype, page):
    """K6's quantized stage (the same arithmetic per column), modelled in
    fp32, against the Pallas ``_prefill_kernel`` in interpret mode on its
    tile routine's chunk layouts (g 2; a 9-token window on alternate
    layouts)."""
    q, kp, vp, bt, start = prefill_layout(layout, 2, D, page)
    (jk, jv), (pk, pv) = _quant_pools(kp, vp, kv_dtype)
    window = 9 if list(PREFILL_LAYOUTS).index(layout) % 2 else None
    scale = 1.0 / D ** 0.5
    b, s, n, d = q.shape
    # the chunk's rows as ragged rows on their sequence's table
    rows = q.reshape(b * s, 1, n, d)
    idx = np.repeat(np.arange(b), s)
    pos = (start[:, None] + np.arange(s)[None]).reshape(-1)
    model = _stage_model(pk, pv, page)
    ours = _model_rows(model, rows, bt, idx, pos, None, window, scale)
    interp = np.asarray(pallas_prefill(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(start),
        scale=scale, sliding_window=window, interpret=True))
    np.testing.assert_allclose(ours.reshape(b, s, n, d), interp, atol=QTOL,
                               rtol=QTOL)
    assert model["sentinel"] > 0


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_stage_model_matches_pallas_decode(kv_dtype, page, window):
    """K5's quantized stage (K4's routine, each row a tile of one),
    modelled in fp32, against the Pallas ``_decode_kernel`` in interpret
    mode: rows at page boundaries, a long context and position 0."""
    q, kp, vp, tables, _, _, _, _ = ragged_layout("long", 1, D, page)
    pos = np.asarray([7, 8, 15, 16, 63, 64, 300, 0], np.int32)
    tables = tables[np.arange(len(pos)) % 4 + 1]
    q = q[:len(pos)]
    (jk, jv), (pk, pv) = _quant_pools(kp, vp, kv_dtype)
    scale = 1.0 / D ** 0.5
    model = _stage_model(pk, pv, page)
    ours = _model_rows(model, q, tables, np.arange(len(pos)), pos, None,
                       window, scale)
    interp = np.asarray(pallas_decode(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(pos),
        scale=scale, sliding_window=window, interpret=True))
    np.testing.assert_allclose(ours, interp, atol=QTOL, rtol=QTOL)
    assert model["sentinel"] > 0
