"""CPU rehearsals of the bf16 tensor-core kernels' tilings (K4 `csrc/rel_attention.cu`
namespace tc, K2 `csrc/fused_mbconv.cu` namespace tc), held against the plain versions.

A CUDA kernel cannot run here, so each test below walks the kernel's plan in
PyTorch with the kernel's own index arithmetic: tiles, staged windows and
their zero fill, the shear read by address, the softmax of the one-pass and
the two-pass kernel, skipped masked tiles, the raw sum; the halo tile, the
padded Cin, the hidden chunks and the split partials summed in a fixed
order. An index error in the plan shows here as a mismatch against the
plain version.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from openstereo_tpu_torch import ops
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

MASK = -1e30
# K2's bf16 tiling (csrc/fused_mbconv.cu, namespace tc): output tile rows x cols
# (TH, TWD) and hidden channels per chunk (HC)
TILE_H, TILE_W, HIDDEN_CHUNK = 8, 16, 32


def k4_plan(q, k, v, ke, qe, nheads, masked, need_raw, tq=64, jc=64):
    """K4's tile loop: a block per (line, 64 query rows), warps of 16 rows.
    P2 = Q_w·KE[tq-16-16w, +80)ᵀ and P3 = K_w·QE[16w, +80)ᵀ per warp w, read
    at P2[il][15 - il%16 + jl] and P3[jl][63 - il + jl%16]; masked launches
    skip the key tiles above the diagonal; raw sums the heads. Where the
    one-pass kernel runs (hd <= 32, W <= 320), each head keeps its tiles'
    scores, then takes the row max m, l = sum exp(s - m) and p = exp(s - m)/l;
    else pass 0 finds m and l online over the tiles and pass 1 computes the
    scores again. p is rounded to v's dtype before p·v."""
    b, w, e = q.shape
    hd, nw = e // nheads, tq // 16
    one_pass = hd <= 32 and w <= 5 * jc
    f = [t.float() for t in (q, k, v, ke, qe)]
    out = torch.zeros(b, w, e)
    raw = torch.full((b, w, w), float("nan")) if need_raw else None
    ar = torch.arange

    def rows(src, r0, n):  # staged rows r0..r0+n of a [R, hd] slice, 0 outside
        idx = ar(r0, r0 + n)
        ok = (idx >= 0) & (idx < src.shape[0])
        return torch.where(ok[:, None], src[idx.clamp(0, src.shape[0] - 1)], 0.0)

    for bi in range(b):
        for i0 in range(0, w, tq):
            nq = min(tq, w - i0)
            ntiles = (i0 + nq - 1) // jc + 1 if masked else math.ceil(w / jc)
            rs = torch.zeros(tq, w)
            il = ar(tq)[:, None]
            for h in range(nheads):
                c = slice(h * hd, (h + 1) * hd)
                qs = rows(f[0][bi, :, c], i0, tq)

                def tile(kt, add_raw):  # the block's 64 x 64 scores of key tile kt, v rows
                    j0 = kt * jc
                    ks = rows(f[1][bi, :, c], j0, jc)
                    rbase = w - i0 - tq + j0
                    kes, qes = rows(f[3][:, c], rbase, tq + jc), rows(f[4][:, c], rbase, tq + jc)
                    p2 = torch.cat([qs[16 * x:16 * x + 16] @ kes[tq - 16 - 16 * x:][:80].T
                                    for x in range(nw)])          # [tq, 80]
                    p3 = torch.cat([ks[16 * x:16 * x + 16] @ qes[16 * x:16 * x + 80].T
                                    for x in range(nw)])          # [jc, 80]
                    jl = ar(jc)[None, :]
                    s = qs @ ks.T + p2[il, 15 - il % 16 + jl] + p3[jl, 63 - il + jl % 16]
                    j = j0 + jl
                    if masked:
                        s = torch.where(j > i0 + il, torch.tensor(MASK), s)
                    if add_raw:
                        cols = slice(j0, min(j0 + jc, w))
                        rs[:, cols] += s[:, :cols.stop - j0]
                    return torch.where(j >= w, torch.tensor(-math.inf), s), \
                        rows(f[2][bi, :, c], j0, jc)

                o = torch.zeros(tq, hd)
                if one_pass:
                    tiles = [tile(kt, need_raw) for kt in range(ntiles)]
                    m = torch.stack([t[0].amax(1) for t in tiles]).amax(0)[:, None]
                    ex = [torch.exp(t[0] - m) for t in tiles]
                    inv = 1 / sum(x.sum(1, keepdim=True) for x in ex)
                    for x, (_, vs) in zip(ex, tiles):
                        o = o + (x * inv).to(v.dtype).float() @ vs
                else:
                    m = torch.full((tq, 1), -math.inf)
                    l = torch.zeros(tq, 1)
                    for kt in range(ntiles):
                        s, _ = tile(kt, need_raw)
                        mn = torch.maximum(m, s.amax(1, keepdim=True))
                        l = l * torch.exp(m - mn) + torch.exp(s - mn).sum(1, keepdim=True)
                        m = mn
                    for kt in range(ntiles):
                        s, vs = tile(kt, False)
                        o = o + (torch.exp(s - m) / l).to(v.dtype).float() @ vs
                out[bi, i0:i0 + nq, c] = o[:nq]
            if need_raw:
                iq = ar(nq)[:, None]
                jw = ar(w)[None, :]
                raw[bi, i0:i0 + nq] = torch.where(masked & (jw > i0 + iq),
                                                  torch.tensor(nheads * MASK), rs[:nq])
    return out.to(v.dtype), raw


def _k4_case(seed, b, w, e, nh):
    g = torch.Generator().manual_seed(seed)
    sc = (e // nh) ** -0.5
    q, k, v = (torch.randn(b, w, e, generator=g) for _ in range(3))
    ke, qe = (torch.randn(2 * w - 1, e, generator=g) * 0.5 for _ in range(2))
    return [q * sc, k, v, ke, qe * sc]


@pytest.mark.parametrize("b,w,e,nh,masked,need_raw", [
    (1, 70, 32, 2, True, True),    # 2 query and 2 key tiles, W ragged, hd 16
    (2, 130, 16, 2, True, False),  # 3 x 3 tiles, masked tiles skipped, hd 8 (k padded)
    (1, 1, 64, 1, True, True),     # W = 1, hd 64: the two-pass kernel
    (1, 40, 64, 2, False, True),   # one ragged tile, hd 32
    (1, 330, 16, 1, True, True),   # W > 320: the two-pass kernel, 6 x 6 tiles
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_tile_plan_matches_plain(b, w, e, nh, masked, need_raw, dtype):
    """f32: the plan agrees with the plain version to 1e-5 (out) and 1e-4
    (raw), as the plain version agrees with the JAX package. bf16: both
    round p to bf16 before p·v; the sums differ only in order, so out agrees
    within one bf16 rounding (2^-7 of the value, + 1e-6)."""
    args = [a.to(dtype) for a in _k4_case(w + e, b, w, e, nh)]
    got, raw = k4_plan(*args, nh, masked, need_raw)
    ref, ref_raw = ops.rel_attention_plain(*args, nh, masked, need_raw)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), **tol)
    if need_raw:
        fin = ref_raw.abs() < 1e20
        assert (raw[~fin] < -1e29).all() and not torch.isnan(raw).any()
        np.testing.assert_allclose(raw[fin].numpy(), ref_raw[fin].numpy(), rtol=1e-4, atol=1e-4)


def k2_plan(x, w1, b1, dw, b2, w2, b3, residual, splits):
    """K2's plan: 8x16 output tiles with a 10x18 halo padded to 192 pixels,
    Cin padded to a multiple of 16 with zeros, 32-channel hidden chunks
    (weights beyond Ch zero), h zeroed outside the image and rounded to x's
    dtype, d rounded, each split's f32 partial projection, the partials
    summed in split order, then b3 and the residual."""
    bsz, cin, hh, ww = x.shape
    ch, cout = w1.shape[1], w2.shape[1]
    cinp = -(-cin // 16) * 16
    nchunks = math.ceil(ch / HIDDEN_CHUNK)
    cps = math.ceil(nchunks / splits)
    chp = nchunks * HIDDEN_CHUNK
    w1p = torch.zeros(cinp, chp)
    w1p[:cin, :ch] = w1.float()
    dwp, b1p, b2p = torch.zeros(9, chp), torch.zeros(chp), torch.zeros(chp)
    dwp[:, :ch], b1p[:ch], b2p[:ch] = dw.float(), b1, b2
    w2p = torch.zeros(chp, cout)
    w2p[:ch] = w2.float()
    part = torch.zeros(splits, bsz, cout, hh, ww)
    for bi in range(bsz):
        for h0 in range(0, hh, TILE_H):
            for wo in range(0, ww, TILE_W):
                gh = torch.arange(h0 - 1, h0 + TILE_H + 1)[:, None]
                gw = torch.arange(wo - 1, wo + TILE_W + 1)[None, :]
                inside = (gh >= 0) & (gh < hh) & (gw >= 0) & (gw < ww)      # [10, 18]
                xs = torch.zeros(192, cinp)
                xs[:180, :cin] = torch.where(
                    inside, x[bi][:, gh.clamp(0, hh - 1), gw.clamp(0, ww - 1)].float(),
                    0.0).reshape(cin, 180).T
                for s in range(splits):
                    for ck in range(s * cps, min(nchunks, s * cps + cps)):
                        js = slice(ck * HIDDEN_CHUNK, (ck + 1) * HIDDEN_CHUNK)
                        hx = (xs @ w1p[:, js] + b1p[js]).clamp(0, 6)[:180].reshape(10, 18, -1)
                        hx = torch.where(inside[..., None], hx, 0.0).to(x.dtype).float()
                        d = sum(hx[di:di + TILE_H, dj:dj + TILE_W] * dwp[3 * di + dj, js]
                                for di in range(3) for dj in range(3))
                        d = (d + b2p[js]).clamp(0, 6).to(x.dtype).float()        # [8, 16, 32]
                        y = (d.reshape(-1, HIDDEN_CHUNK) @ w2p[js]).T.reshape(cout, TILE_H, TILE_W)
                        rh, rw = min(TILE_H, hh - h0), min(TILE_W, ww - wo)
                        part[s, bi, :, h0:h0 + rh, wo:wo + rw] += y[:, :rh, :rw]
    y = part[0]
    for s in range(1, splits):
        y = y + part[s]
    y = y + b3[:, None, None]
    if residual:
        y = y + x.float()
    return y.to(x.dtype)


def launcher_splits(b, h, w, ch, sms):
    """`tc::pick_splits` in csrc/fused_mbconv.cu: 1 where the tiles fill two
    waves of the SMs, else enough blocks to fill them, at most one per chunk,
    every split taking ceil(chunks / S) chunks."""
    tiles = b * math.ceil(h / TILE_H) * math.ceil(w / TILE_W)
    chunks = math.ceil(ch / HIDDEN_CHUNK)
    if tiles >= 2 * sms:
        return 1
    per_split = math.ceil(chunks / min(chunks, math.ceil(2 * sms / tiles)))
    return math.ceil(chunks / per_split)


def test_k2_split_counts_at_main_path_shapes():
    """The split count the launcher picks at each K2 shape of the
    LightStereo-S, CoEx, MSNet3D and MSNet2D paths on a 132-SM H100
    (chip_smoke.py's K2_SPLITS_132, which the card run holds the launcher
    to), and that every split has chunks."""
    want = chip_smoke.K2_SPLITS_132
    assert set(want) == {(sh[0], sh[1], sh[2], sh[4]) for sh in chip_smoke.K2_ALL_SHAPES}
    for (b, h, w, ch), s in want.items():
        assert launcher_splits(b, h, w, ch, 132) == s, (b, h, w, ch)
        tiles = b * math.ceil(h / TILE_H) * math.ceil(w / TILE_W)
        chunks = math.ceil(ch / HIDDEN_CHUNK)
        assert (s - 1) * math.ceil(chunks / s) < chunks   # no split without chunks
        assert (s == 1) == (tiles >= 2 * 132)            # split only below two waves


@pytest.mark.parametrize("shape,residual,splits", [
    ((1, 9, 21, 24, 80, 24), True, 1),     # ragged tiles and last chunk, Cin 24 padded to 32
    ((1, 9, 21, 24, 80, 40), False, 3),    # a split per chunk
    ((2, 5, 17, 16, 64, 16), True, 2),
    ((1, 9, 17, 48, 144, 48), True, 2),    # MSNet2D dres: Ch 144, 4 1/2 chunks, S as at 136x240
    ((1, 3, 9, 192, 384, 192), True, 12),  # MSNet2D conv4: Cin and Cout 192, a split per chunk
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_tile_plan_matches_plain(shape, residual, splits, dtype):
    """f32: the plan agrees with the plain version to 1e-5 (relative, 1e-4
    absolute); bf16: both round h and d, so they agree within one bf16
    rounding (2^-7 of the value, + 1e-6)."""
    b, h, w, cin, ch, cout = shape
    g = torch.Generator().manual_seed(sum(shape))
    x = (torch.randn(b, cin, h, w, generator=g) * 3).to(dtype)
    args = [torch.randn(cin, ch, generator=g) * cin ** -0.5, torch.randn(ch, generator=g) * 0.5,
            torch.randn(9, ch, generator=g) * 0.6, torch.randn(ch, generator=g) * 0.1,
            torch.randn(ch, cout, generator=g) * ch ** -0.5, torch.randn(cout, generator=g) * 0.1]
    args = [a.to(dtype) if i % 2 == 0 else a for i, a in enumerate(args)]
    got = k2_plan(x, *args, residual, splits)
    ref = ops.mbconv_plain(x, *args, residual=residual)
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32 else dict(rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), **tol)


# K1/K3's tiling (csrc/cost_volume.cu): columns and disparities per thread (an
# item), channels per staged chunk at most, threads per block at most
CV_CW, CV_DPT, CV_CC_MAX, CV_NT_MAX, CV_STAGES = 8, 8, 32, 192, 3


def cv_plan(b, c, h, w, d, g, sms, threads_sm=2048, smem_max=232448, elem=2):
    """`make_plan` in csrc/cost_volume.cu: lanes per item `cs` while the items
    fill under a quarter of the resident threads, tiles of `twc` 8-column chunks
    (at most CV_NT_MAX threads, halved while there are fewer than 4 tiles per
    SM), `cc` channels per stage that fit shared memory."""
    cg, n_dc, n_wc = c // g, math.ceil(d / CV_DPT), math.ceil(w / CV_CW)
    rows, pad = b * g * h, CV_DPT * n_dc
    cs = 1
    while (cs < 8 and 2 * cs <= cg and n_dc * 2 * cs <= CV_NT_MAX
           and rows * n_dc * n_wc * 2 * cs <= sms * threads_sm // 4):
        cs *= 2
    twc = n_wc
    while twc > 1 and n_dc * twc * cs > CV_NT_MAX:
        twc = (twc + 1) // 2
    while twc > 1 and rows * math.ceil(n_wc / twc) < 4 * sms:
        twc = (twc + 1) // 2
    cc = min(cg, CV_CC_MAX)
    while cc * (2 * twc * CV_CW + pad) * elem * CV_STAGES > smem_max and (twc > 1 or cc > 1):
        if twc > 1:
            twc = (twc + 1) // 2
        else:
            cc = (cc + 1) // 2
    return dict(cs=cs, twc=twc, cc=cc, nt=math.ceil(n_dc * twc * cs / 32) * 32,
                n_wt=math.ceil(n_wc / twc))


def cv_walk(left, right, max_disp, groups, cs, twc, cc, **_):
    """The kernel's loop: per tile (b, g, h, w-tile) it stages cc channels at a
    time, left columns w_s .. and right columns w_s - pad .., zeros outside the
    frame; item x // cs of the tile (column chunk fastest, then disparity chunk)
    reads 8 left values and the 16-column right window at pad + 8 wcl - 8 dc - 8
    and adds round(l[j] * win[j - k + 8]) in f32, lane p of the item taking the
    p-th run of ceil(cc / cs) channels of each chunk; the lanes meet in a
    butterfly (own + partner's), the quotient by cg is rounded to f32 and then
    to the input dtype, and lane p stores disparities k % cs == p, d < D, w < W."""
    b, c, h, w = left.shape
    cg, n_dc, n_wc = c // groups, math.ceil(max_disp / CV_DPT), math.ceil(w / CV_CW)
    pad, tw, n_wt, run = CV_DPT * n_dc, twc * CV_CW, math.ceil(n_wc / twc), math.ceil(cc / cs)
    item = torch.arange(n_dc * twc)
    wcl, dc = item % twc, item // twc
    jk = torch.arange(CV_CW)[None, :] - torch.arange(CV_DPT)[:, None] + CV_DPT  # [k, j]
    l_cols = CV_CW * wcl[:, None] + torch.arange(CV_CW)                          # [item, j]
    r_cols = (pad + CV_CW * wcl - CV_DPT * dc - CV_DPT)[:, None, None] + jk      # [item, k, j]
    out = torch.full((b, groups, max_disp, h, w), float("nan"), dtype=left.dtype)

    def staged(src, rows, cols):  # [n, len(cols)], zeros outside [0, W)
        ok = (cols >= 0) & (cols < w)
        return torch.where(ok, src[rows][:, cols.clamp(0, w - 1)], torch.zeros((), dtype=src.dtype))

    for bi, gi, hi, wt in np.ndindex(b, groups, h, n_wt):
        w_s = wt * tw
        acc = torch.zeros(cs, len(item), CV_DPT, CV_CW)
        for c0 in range(0, cg, cc):
            n = min(cc, cg - c0)
            rows = gi * cg + c0 + torch.arange(n)
            sl = staged(left[bi, :, hi], rows, w_s + torch.arange(tw))
            sr = staged(right[bi, :, hi], rows, w_s - pad + torch.arange(pad + tw))
            for part in range(cs):
                for ci in range(part * run, min(n, (part + 1) * run)):
                    prod = sl[ci][l_cols][:, None, :] * sr[ci][r_cols]  # rounded in the dtype
                    acc[part] += prod.float()
        m = 1
        while m < cs:
            acc = acc + acc[torch.tensor([p ^ m for p in range(cs)])]
            m *= 2
        q = (acc.double() / cg).float().to(left.dtype)  # [part, item, k, j]
        k = torch.arange(CV_DPT)[None, :, None]
        q = q[k % cs, item[:, None, None], k, torch.arange(CV_CW)]  # lane k % cs's copy
        d = (CV_DPT * dc[:, None, None] + k).expand_as(q)
        col = (w_s + l_cols[:, None, :]).expand_as(q)
        keep = (d < max_disp) & (col < w)
        out[bi, gi, d[keep], hi, col[keep]] = q[keep]
    return out


def test_cv_plan_at_main_path_shapes():
    """What `make_plan` picks on a 132-SM H100: K3 (GwcNet, MSNet3D) one tile
    per group row, 180 of 192 threads, no channel split; K1 (LightStereo-S,
    CoEx) two lanes per item and 64-column tiles, so that its 24,480 items
    fill the card."""
    assert cv_plan(*chip_smoke.K3_SHAPE, sms=132) == dict(cs=1, twc=30, cc=8, nt=192, n_wt=1)
    b, c, h, w, d = chip_smoke.K1_SHAPE
    assert cv_plan(b, c, h, w, d, 1, sms=132) == dict(cs=2, twc=8, cc=24, nt=96, n_wt=4)
    # CoEx's cosine volume, C 48: the same tiles, channels staged 32 then 16
    b, c, h, w, d = chip_smoke.COEX_K1_SHAPE
    assert cv_plan(b, c, h, w, d, 1, sms=132) == dict(cs=2, twc=8, cc=32, nt=96, n_wt=4)


CV_MAIN_ROWS = [
    ((1, 320, 2, 240, 48, 40), cv_plan(*chip_smoke.K3_SHAPE, sms=132), "K3's plan, cg 8"),
    ((1, 24, 2, 240, 48, 1), cv_plan(*chip_smoke.K1_SHAPE, 1, sms=132), "K1's plan, cg 24"),
    ((1, 48, 2, 240, 48, 1), cv_plan(*chip_smoke.COEX_K1_SHAPE, 1, sms=132),
     "K1's plan at C 48 (CoEx), a ragged channel chunk"),
    ((1, 80, 2, 40, 16, 1), cv_plan(1, 80, 2, 40, 16, 1, sms=132), "cg 80: three chunks"),
]
CV_EDGES = [(shape, cv_plan(*shape, sms=132), what) for shape, what in chip_smoke.K3_EDGES]


@pytest.mark.parametrize("shape,plan,what", CV_MAIN_ROWS + CV_EDGES,
                         ids=[w for _, _, w in CV_MAIN_ROWS + CV_EDGES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cv_tile_plan_matches_plain(shape, plan, what, dtype):
    """The walk of the kernel's plan against the plain version: bit for bit in
    bf16 (the f32 sums of bf16 products are exact here, so their order does not
    show), 1e-5 in f32."""
    b, c, h, w, d, g = shape
    gen = torch.Generator().manual_seed(sum(shape))
    left, right = (torch.randn(b, c, h, w, generator=gen).to(dtype) for _ in range(2))
    got = cv_walk(left, right, d, g, **plan)
    ref = ops.build_gwc_volume(left, right, d, g)
    if dtype == torch.bfloat16:
        assert torch.equal(got, ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
