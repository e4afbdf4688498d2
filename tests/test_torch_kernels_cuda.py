"""The port's CUDA and Triton kernels (K1-K10) against their plain versions
on the card, at small shapes with ragged edges. Marked ``cuda``: they skip where
there is no CUDA device. On a machine with a card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

import diffusiondepth_tpu_torch as port
from diffusiondepth_tpu_torch import LAUNCHES
from diffusiondepth_tpu_torch.models.backbones.swin import shifted_window_mask
from diffusiondepth_tpu_torch.ops import fused_denoiser as fd
from diffusiondepth_tpu_torch.ops import layernorm as ln
from diffusiondepth_tpu_torch.ops import window_attention as wa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# the six links of the chain (ne0, ne1, fa, fb, pr0, pr1), then ragged
# shapes: W below one 128-pixel tile, one past a tile, H = 1, B = 3 (the
# first, 256 -> 64 with GroupNorm, add and stats, is the four-link chain's pr0)
@pytest.mark.parametrize("cin,cout,gn,add,stats,B,H,w", [
    (16, 64, False, False, True, 2, 6, 130), (64, 256, True, False, True, 2, 6, 37),
    (256, 256, True, True, False, 2, 6, 129), (256, 256, False, False, False, 2, 6, 20),
    (256, 64, False, False, True, 2, 6, 128), (64, 16, True, False, True, 2, 6, 5),
    (256, 64, True, True, True, 2, 6, 129), (256, 256, True, True, True, 3, 1, 5),
    (16, 64, False, False, True, 3, 1, 129), (64, 16, True, False, True, 3, 2, 257)])
def test_conv_link_matches_plain(dev, cin, cout, gn, add, stats, B, H, w):
    """y within one bf16 step (1e-2 of the largest value), GroupNorm
    partials summed over blocks to f32 order (1e-4); two launches give the
    same bits."""
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn(B, H, w, cin, generator=g, device=dev).to(bf)
    wt = (torch.randn(3, 3, cin, cout, generator=g, device=dev) / (9 * cin) ** 0.5).to(bf)
    bias = torch.randn(cout, generator=g, device=dev) * 0.1
    kw = {"stats": stats}
    if gn:
        kw.update(aeff=1 + 0.1 * torch.randn(B, cin, generator=g, device=dev),
                  beff=0.1 * torch.randn(B, cin, generator=g, device=dev), relu=True)
    if add:
        kw.update(add=torch.randn(B, H, w, cin, generator=g, device=dev).to(bf),
                  te=(0.1 * torch.randn(B, cin, generator=g, device=dev)).to(bf))
    n0 = LAUNCHES["conv_link"]
    y, ps = fd.conv_link(x, wt, bias, **kw)
    y2, ps2 = fd.conv_link(x, wt, bias, **kw)
    yp, psp = fd.conv_link_plain(x, wt, bias, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["conv_link"] == n0 + 2
    assert torch.equal(y, y2)
    assert (y.float() - yp.float()).abs().max() <= 1e-2 * yp.float().abs().max()
    assert (ps is None) == (not stats)
    if stats:
        assert torch.equal(ps, ps2) and ps.shape == (B, H * -(-w // 128), 2, cout)
        s, sp = ps.sum(1), psp.sum(1)
        assert (s - sp).abs().max() <= 1e-4 * sp.abs().max()


# the transformed links that take K1's transform-warp path: fa (256 ->
# 256, GroupNorm, ReLU, add and te; also with stats), the 'add' chain's pr0
# (256 -> 64 with stats); and two flag sets the chains do not use, which
# take K1's own loop: GroupNorm and ReLU without the add map, the add map
# and te alone, on both output widths; at the serve latent and the ragged
# shapes above
@pytest.mark.parametrize("cout,gn,add,stats", [
    (256, True, True, False), (256, True, True, True), (64, True, True, True),
    (64, True, False, True), (256, False, True, True), (64, False, True, False)],
    ids=["fa", "fa-stats", "add-pr0", "gn-only", "add-only-256", "add-only-64"])
@pytest.mark.parametrize("B,H,w", [(8, 176, 608), (2, 6, 129), (3, 1, 5), (3, 2, 257)])
def test_conv_link_xf_matches_untransformed_link(dev, cout, gn, add, stats, B, H, w):
    """A transformed link equals, bit for bit (y and partials), the
    untransformed link on the plainly transformed input: the same products
    in the same order. With the chains' flags it takes the transform-warp
    path, counted as one conv_link and one conv_link_xf launch; with other
    flags, and the untransformed link, one conv_link only."""
    g = torch.Generator(device=dev).manual_seed(11)
    bf, cin = torch.bfloat16, 256
    x = torch.randn(B, H, w, cin, generator=g, device=dev).to(bf)
    wt = (torch.randn(3, 3, cin, cout, generator=g, device=dev) / (9 * cin) ** 0.5).to(bf)
    bias = torch.randn(cout, generator=g, device=dev) * 0.1
    kw = {}
    if gn:
        kw.update(aeff=1 + 0.1 * torch.randn(B, cin, generator=g, device=dev),
                  beff=0.1 * torch.randn(B, cin, generator=g, device=dev), relu=True)
    if add:
        kw.update(add=torch.randn(B, H, w, cin, generator=g, device=dev).to(bf),
                  te=(0.1 * torch.randn(B, cin, generator=g, device=dev)).to(bf))
    xf = gn and add
    assert fd.conv_link_xf_path(cin, cout, fd.link_flags(
        kw.get("aeff"), gn, kw.get("add"), kw.get("te"), stats)) == xf
    n0 = dict(LAUNCHES)
    y, ps = fd.conv_link(x, wt, bias, stats=stats, **kw)
    assert LAUNCHES["conv_link_xf"] == n0["conv_link_xf"] + xf
    v = fd._link_input_plain(x, kw.get("aeff"), kw.get("beff"), gn, kw.get("add"),
                             kw.get("te")).to(bf).contiguous()
    y_u, ps_u = fd.conv_link(v, wt, bias, stats=stats)
    torch.cuda.synchronize()
    assert LAUNCHES["conv_link"] == n0["conv_link"] + 2
    assert LAUNCHES["conv_link_xf"] == n0["conv_link_xf"] + xf
    assert torch.equal(y, y_u)
    assert (ps is None) == (not stats)
    if stats:
        assert torch.equal(ps, ps_u)


def test_conv_link_xf_path_matches_library(dev):
    """The Python routing rule that counts conv_link_xf launches makes the
    library's choice for every flag set and a spread of channel counts."""
    lib = fd.native.load("conv_link")
    for cin in (16, 64, 80, 128, 192, 256, 512):
        for cout in (16, 64, 128, 256, 512):
            for flags in range(32):
                assert bool(lib.conv_link_xf_path(cin, cout, flags)) == fd.conv_link_xf_path(
                    cin, cout, flags), (cin, cout, flags)


def test_ddim_step_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    u6 = torch.randn(2, 5, 7, 16, generator=g, device=dev).to(torch.bfloat16)
    x = torch.randn(2, 5, 7, 16, generator=g, device=dev)
    a = 1 + 0.1 * torch.randn(2, 16, generator=g, device=dev)
    b = 0.1 * torch.randn(2, 16, generator=g, device=dev)
    sched = torch.tensor([0.3, 0.954, 0.5, 0.866], device=dev)
    out = fd.ddim_step(u6, a, b, x, sched)
    ref = fd.ddim_step_plain(u6, a, b, x, sched)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("dtype,masked", [
    (torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, True)])
def test_window_attention_matches_plain(dev, dtype, masked):
    """bf16 to one output step (2e-2), f32 to summation order (1e-5)."""
    g = torch.Generator(device=dev).manual_seed(2)
    nw, heads = 6, 3
    qkv = torch.randn(2, nw, 49, 3 * 32 * heads, generator=g, device=dev).to(dtype)
    bias = 0.1 * torch.randn(heads, 49, 49, generator=g, device=dev)
    mask = torch.from_numpy(shifted_window_mask(14, 21, 7, 3)).to(dev) if masked else None
    out = wa.window_attention(qkv, bias, mask, 32 ** -0.5, heads)
    ref = wa.window_attention_plain(qkv, bias, mask, 32 ** -0.5, heads)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert (out.float() - ref.float()).abs().max() <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_attention_repeatable(dev, dtype):
    """K4: two launches on the same inputs give the same bits."""
    g = torch.Generator(device=dev).manual_seed(10)
    nw, heads = 6, 3
    qkv = _rand(g, dev, 2, nw, 49, 3 * 32 * heads, dtype=dtype)
    bias = _rand(g, dev, heads, 49, 49, scale=0.1)
    mask = torch.from_numpy(shifted_window_mask(14, 21, 7, 3)).to(dev)
    out = wa.window_attention(qkv, bias, mask, 32 ** -0.5, heads)
    again = wa.window_attention(qkv, bias, mask, 32 ** -0.5, heads)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


def _rand(g, dev, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _coefs(g, dev, B, C):
    c = torch.zeros(B, 8, C, device=dev)
    c[:, 0] = 1 + 0.2 * torch.randn(B, C, generator=g, device=dev)
    c[:, 1:4] = 0.2 * torch.randn(B, 3, C, generator=g, device=dev)
    c[:, 4] = 1 + 0.2 * torch.randn(B, C, generator=g, device=dev)
    return c


def test_sched_step_matches_plain(dev):
    """K2: x' to f32 rounding order (1e-5 of the largest value), its bf16
    copy to one bf16 step of that."""
    g = torch.Generator(device=dev).manual_seed(3)
    u6 = _rand(g, dev, 2, 5, 7, 16, dtype=torch.bfloat16)
    x = _rand(g, dev, 2, 5, 7, 16)
    a, b = 1 + _rand(g, dev, 2, 16, scale=0.1), _rand(g, dev, 2, 16, scale=0.1)
    sched = torch.tensor([0.3, 0.954, 0.5, 0.866], device=dev)
    n0 = LAUNCHES["sched_step"]
    xp, xpb = fd.sched_step(u6, a, b, x, sched)
    rp, rpb = fd.sched_step_plain(u6, a, b, x, sched)
    torch.cuda.synchronize()
    assert LAUNCHES["sched_step"] == n0 + 1 and xpb.dtype == torch.bfloat16
    assert (xp - rp).abs().max() <= 1e-5 * rp.abs().max()
    assert (xpb.float() - rpb.float()).abs().max() <= 1e-2 * rp.abs().max()


@pytest.mark.parametrize("with_b", [True, False])
def test_sched_bwd_matches_plain(dev, with_b):
    """K6: dx to f32 order (1e-5), t6 to one bf16 step (1e-2 of the
    largest value), the partials summed over blocks to 1e-4."""
    g = torch.Generator(device=dev).manual_seed(4)
    B, H, W = 2, 9, 37
    dxp = _rand(g, dev, B, H, W, 16)
    dxpb = _rand(g, dev, B, H, W, 16, dtype=torch.bfloat16) if with_b else None
    u6 = _rand(g, dev, B, H, W, 16, dtype=torch.bfloat16)
    coefs = _coefs(g, dev, B, 16)
    sched = torch.tensor([0.3, 0.954, 0.5, 0.866], device=dev)
    dx, t6, ps = fd.sched_bwd(dxp, dxpb, u6, coefs, sched)
    rdx, rt6, rps = fd.sched_bwd_plain(dxp, dxpb, u6, coefs, sched)
    torch.cuda.synchronize()
    assert (dx - rdx).abs().max() <= 1e-5 * rdx.abs().max()
    assert (t6.float() - rt6.float()).abs().max() <= 1e-2 * rt6.float().abs().max()
    s, sp = ps.sum(1), rps.sum(1)
    assert (s - sp).abs().max() <= 1e-4 * sp.abs().max()


@pytest.mark.parametrize("cin,cout,gn_next,gn_in,add,B,H,w", [
    (16, 64, True, False, False, 2, 6, 130), (64, 256, True, True, False, 2, 6, 37),
    (256, 256, False, True, True, 2, 6, 129), (256, 256, False, False, False, 2, 6, 20),
    (256, 64, True, False, False, 2, 6, 45), (64, 16, True, True, False, 2, 6, 5),
    (256, 256, False, True, True, 3, 1, 5), (16, 64, True, False, False, 3, 2, 129),
    (64, 16, True, True, False, 3, 1, 65), (64, 256, True, True, False, 3, 3, 128),
    (256, 64, True, True, True, 2, 6, 129), (256, 64, True, True, True, 3, 1, 5)])
def test_conv_link_bwd_matches_plain(dev, cin, cout, gn_next, gn_in, add, B, H, w):
    """K5 at the six kinds of link, then ragged shapes (W below a tile,
    one past a tile, H = 1, B = 3), then the 'add' chain's pr0 (GN_NEXT |
    GN_IN | ADD | TE): t and d(add) within one bf16 step of
    the largest value (1e-2), dW, dbias and the partials to f32 summation
    order (1e-3 of the largest value); and two launches give the same
    bits."""
    g = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16
    r = _rand(g, dev, B, H, w, cout, dtype=bf)
    wt = _rand(g, dev, 3, 3, cin, cout, scale=(9 * cin) ** -0.5, dtype=bf)
    u_in = _rand(g, dev, B, H, w, cin, dtype=bf)
    kw = {}
    if gn_next:
        kw.update(u_next=_rand(g, dev, B, H, w, cout, dtype=bf), coef_next=_coefs(g, dev, B, cout))
    if gn_in:
        kw["coef_in"] = _coefs(g, dev, B, cin)
    if add:
        kw.update(add=_rand(g, dev, B, H, w, cin, dtype=bf),
                  te=_rand(g, dev, B, cin, scale=0.1, dtype=bf))
    n0 = LAUNCHES["conv_link_bwd"]
    out = fd.conv_link_bwd(r, wt, u_in, **kw)
    again = fd.conv_link_bwd(r, wt, u_in, **kw)
    ref = fd.conv_link_bwd_plain(r, wt, u_in, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["conv_link_bwd"] == n0 + 2
    for a, b_ in zip(out, again):
        assert (a is None and b_ is None) or torch.equal(a, b_)
    t, dw, db, ps, da = out
    rt_, rdw, rdb, rps, rda = ref
    assert (t.float() - rt_.float()).abs().max() <= 1e-2 * rt_.float().abs().max()
    assert (dw - rdw).abs().max() <= 1e-3 * rdw.abs().max()
    assert (db - rdb).abs().max() <= 1e-3 * rdb.abs().max()
    assert (ps is None) == (not gn_in) and (da is None) == (not add)
    if gn_in:
        s, sp = ps.sum(1), rps.sum(1)
        assert (s - sp).abs().max() <= 1e-3 * sp.abs().max()
    if add:
        assert (da.float() - rda.float()).abs().max() <= 1e-2 * rda.float().abs().max()


@pytest.mark.parametrize("dtype,masked", [
    (torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, True)])
def test_window_attention_bwd_matches_plain(dev, dtype, masked):
    """K7: dqkv in bf16 to one output step of the largest value (2e-2),
    in f32 to summation order (1e-4); dbias to 1e-4 of its largest value;
    two launches give the same bits."""
    g = torch.Generator(device=dev).manual_seed(6)
    nw, heads = 6, 3
    qkv = _rand(g, dev, 2, nw, 49, 3 * 32 * heads, dtype=dtype)
    dout = _rand(g, dev, 2, nw, 49, 32 * heads, dtype=dtype)
    bias = _rand(g, dev, heads, 49, 49, scale=0.1)
    mask = torch.from_numpy(shifted_window_mask(14, 21, 7, 3)).to(dev) if masked else None
    dq, db = wa.window_attention_bwd(qkv, bias, mask, dout, 32 ** -0.5, heads)
    dq2, db2 = wa.window_attention_bwd(qkv, bias, mask, dout, 32 ** -0.5, heads)
    rq, rb = wa.window_attention_bwd_plain(qkv, bias, mask, dout, 32 ** -0.5, heads)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2) and torch.equal(db, db2)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert (dq.float() - rq.float()).abs().max() <= tol * rq.float().abs().max()
    assert (db - rb).abs().max() <= 1e-4 * rb.abs().max()


@pytest.mark.parametrize("dtype,masked,strided", [
    (torch.bfloat16, False, False), (torch.bfloat16, True, True), (torch.float32, True, False)])
def test_window_attention_split_matches_plain_and_k4(dev, dtype, masked, strided):
    """K8: bf16 to one output step (2e-2), f32 to summation order (1e-5);
    and the same bits as K4 on the same data, which it sums in the same
    order. ``strided`` hands it permuted views of the qkv output, read
    through their strides."""
    g = torch.Generator(device=dev).manual_seed(7)
    nw, heads = 6, 3
    qkv = _rand(g, dev, 2, nw, 49, 3 * 32 * heads, dtype=dtype)
    bias = _rand(g, dev, heads, 49, 49, scale=0.1)
    mask = torch.from_numpy(shifted_window_mask(14, 21, 7, 3)).to(dev) if masked else None
    q, k, v = (t.permute(0, 1, 3, 2, 4) for t in qkv.view(2, nw, 49, 3, heads, 32).unbind(3))
    if not strided:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    n0 = LAUNCHES["window_attention_split"]
    out = wa.window_attention_split(q, k, v, bias, mask, 32 ** -0.5)
    ref = wa.window_attention_split_plain(q, k, v, bias, mask, 32 ** -0.5)
    k4 = wa.window_attention(qkv, bias, mask, 32 ** -0.5, heads)
    torch.cuda.synchronize()
    assert LAUNCHES["window_attention_split"] == n0 + 1 and out.is_contiguous()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert (out.float() - ref.float()).abs().max() <= tol
    assert torch.equal(out.permute(0, 1, 3, 2, 4).reshape(k4.shape), k4)


# bf16 tile edges of the tensor-core K4/K7/K8: windows not a multiple of
# the windows per block (27 over 11 blocks of a head at 48 heads; 600 over
# 528 at one head), B = 1, heads 1 and 48, N = 64 (no padded key) and
# N = 16 (three query warps wholly padded)
@pytest.mark.parametrize("B,nw,heads,n,masked", [
    (3, 9, 48, 49, True), (1, 600, 1, 49, False), (2, 5, 3, 64, True), (2, 5, 3, 16, False),
    (1, 3, 2, 49, True)])
def test_window_attention_bf16_tile_edges(dev, B, nw, heads, n, masked):
    """K4 and K8 within one output step of the plain version (2e-2), K8 with
    K4's bits, K7's dqkv within 2e-2 of the largest value and dbias within
    1e-4; two launches of K4 and of K7 give the same bits."""
    g = torch.Generator(device=dev).manual_seed(9)
    bf = torch.bfloat16
    qkv = _rand(g, dev, B, nw, n, 3 * 32 * heads, dtype=bf)
    dout = _rand(g, dev, B, nw, n, 32 * heads, dtype=bf)
    bias = _rand(g, dev, heads, n, n, scale=0.1)
    mask = None
    if masked:
        mask = -100.0 * (torch.rand(nw, n, n, generator=g, device=dev) < 0.3).float()
    scale = 32 ** -0.5
    n0 = dict(LAUNCHES)
    out = wa.window_attention(qkv, bias, mask, scale, heads)
    out2 = wa.window_attention(qkv, bias, mask, scale, heads)
    ref = wa.window_attention_plain(qkv, bias, mask, scale, heads)
    q, k, v = (t.permute(0, 1, 3, 2, 4) for t in qkv.view(B, nw, n, 3, heads, 32).unbind(3))
    out8 = wa.window_attention_split(q, k, v, bias, mask, scale)
    dq, db = wa.window_attention_bwd(qkv, bias, mask, dout, scale, heads)
    dq2, db2 = wa.window_attention_bwd(qkv, bias, mask, dout, scale, heads)
    rq, rb = wa.window_attention_bwd_plain(qkv, bias, mask, dout, scale, heads)
    torch.cuda.synchronize()
    assert LAUNCHES["window_attention"] == n0["window_attention"] + 2
    assert LAUNCHES["window_attention_bwd"] == n0["window_attention_bwd"] + 2
    assert torch.equal(out, out2)
    assert (out.float() - ref.float()).abs().max() <= 2e-2
    assert torch.equal(out8.permute(0, 1, 3, 2, 4).reshape(out.shape), out)
    assert torch.equal(dq, dq2) and torch.equal(db, db2)
    assert (dq.float() - rq.float()).abs().max() <= 2e-2 * rq.float().abs().max()
    assert (db - rb).abs().max() <= 1e-4 * rb.abs().max()


@pytest.mark.parametrize("m,c", [(300, 192), (129, 384), (37, 3072), (1001, 768), (1, 768),
                                 (5016, 768), (1276, 1536), (1276, 3072),
                                 (1001, 1), (777, 7), (513, 100), (300, 3080), (129, 4100),
                                 (33, 9000), (3, 65536)])
def test_layernorm_fwd_bwd_match_plain(dev, m, c):
    """K9: y within one bf16 step (1e-2 of the largest value), mean to
    1e-5 and inv to 1e-4 (Triton's rsqrt) relative. K10: dx within one
    bf16 step, dscale and dbias to f32 summation order (1e-3 of the
    largest value); two launches give the same bits. M is not a multiple
    of any row block; (1, 768) is one block of one row, the next three are
    Swin-L norms of a 352x906 batch of 4. Then every kind of width: C = 1,
    C % 8 != 0 (K10 on rows staged to ceil8(C)), C above 3072 in K10's
    ring, above its ring (the wide variant), and above K9's one-program
    row (its looped variant), up to 65536."""
    g = torch.Generator(device=dev).manual_seed(8)
    x = _rand(g, dev, m, c, scale=2.0, dtype=torch.bfloat16) + 0.5
    dy = _rand(g, dev, m, c, dtype=torch.bfloat16)
    scale = 1 + _rand(g, dev, c, scale=0.2)
    bias = _rand(g, dev, c, scale=0.1)
    n0 = dict(LAUNCHES)
    y, mean, inv = ln.layernorm_fwd(x, scale, bias, 1e-5)
    ry, rmean, rinv = ln.layernorm_fwd_plain(x, scale, bias, 1e-5)
    dx, ds, db = ln.layernorm_bwd(x, dy, mean, inv, scale)
    dx2, ds2, db2 = ln.layernorm_bwd(x, dy, mean, inv, scale)
    rdx, rds, rdb = ln.layernorm_bwd_plain(x, dy, mean, inv, scale)
    torch.cuda.synchronize()
    assert LAUNCHES["layernorm_fwd"] == n0["layernorm_fwd"] + 1
    assert LAUNCHES["layernorm_bwd"] == n0["layernorm_bwd"] + 2
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2) and torch.equal(db, db2)
    assert (y.float() - ry.float()).abs().max() <= 1e-2 * ry.float().abs().max()
    assert ((mean - rmean).abs() <= 1e-5 * (1 + rmean.abs())).all()
    assert ((inv - rinv).abs() <= 1e-4 * rinv.abs()).all()
    assert (dx.float() - rdx.float()).abs().max() <= 1e-2 * rdx.float().abs().max()
    for a, b_ in ((ds, rds), (db, rdb)):
        assert (a - b_).abs().max() <= 1e-3 * b_.abs().max()


@pytest.mark.parametrize("c", [768, 100])
def test_layernorm_module_offset_view_launches_kernels(dev, c, monkeypatch):
    """``LayerNorm(c, dtype=bf16)`` on a bf16 view one element into its
    storage (not on 16 bytes) runs forward and backward through exactly one
    K9 and one K10 launch (``LayerNormBF16`` copies the view to a 16-byte
    boundary; at C = 100 K10 stages the rows too) and matches the same
    module on the CPU (plain versions): y and dx within one bf16 step,
    dweight and dbias within 1e-3 of the largest value. The plain versions
    are replaced by a trap while the card runs: no CUDA input reaches
    them."""
    from diffusiondepth_tpu_torch.models.common import LayerNorm

    m = 1001
    g = torch.Generator().manual_seed(9)
    mods = [LayerNorm(c, dtype=torch.bfloat16) for _ in range(2)]
    with torch.no_grad():
        mods[0].weight.copy_(1 + 0.2 * torch.randn(c, generator=g))
        mods[0].bias.copy_(0.1 * torch.randn(c, generator=g))
    mods[1].load_state_dict(mods[0].state_dict())
    mods[0].to(dev)
    x = (2 * torch.randn(m, c, generator=g) + 0.5).to(torch.bfloat16)
    dy = torch.randn(m, c, generator=g).to(torch.bfloat16)
    res = []
    for mod, d in zip(mods, (dev, torch.device("cpu"))):
        store = torch.zeros(m * c + 1, dtype=torch.bfloat16, device=d)
        store[1:] = x.reshape(-1).to(d)
        store.requires_grad_()
        xv = store[1:].view(m, c)
        if d.type == "cuda":
            assert xv.data_ptr() % 16 != 0
            with monkeypatch.context() as mp:
                for name in ("layernorm_fwd_plain", "layernorm_bwd_plain"):
                    mp.setattr(ln, name, _trap(name))
                n0 = dict(LAUNCHES)
                y = mod(xv)
                y.backward(dy.to(d))
                torch.cuda.synchronize()
                assert {k: LAUNCHES[k] - n0[k] for k in LAUNCHES} == {
                    k: int(k in ("layernorm_fwd", "layernorm_bwd")) for k in LAUNCHES}
        else:
            y = mod(xv)
            y.backward(dy)
        res.append([t.float().cpu() for t in (y.detach(), store.grad[1:].view(m, c),
                                               mod.weight.grad, mod.bias.grad)])
    for (a, b_), tol in zip(zip(*res), (1e-2, 1e-2, 1e-3, 1e-3)):
        assert (a - b_).abs().max() <= tol * b_.abs().max()


def _trap(name):
    def fn(*args, **kwargs):
        raise AssertionError(f"{name} ran on the card")
    return fn


def test_layernorm_bwd_refuses_misaligned(dev):
    """K10 bulk-copies rows of x and dy from 16-byte boundaries: a view
    that starts one bf16 past one raises by name and launches nothing."""
    m, c = 64, 192
    flat = torch.zeros(m * c + 1, device=dev, dtype=torch.bfloat16)
    x2 = flat[1:].view(m, c)
    dy = torch.zeros(m, c, device=dev, dtype=torch.bfloat16)
    rows = torch.ones(m, device=dev)
    n0 = LAUNCHES["layernorm_bwd"]
    with pytest.raises(ValueError, match="layernorm_bwd.*16-byte"):
        ln.layernorm_bwd(x2, dy, rows, rows, torch.ones(c, device=dev))
    assert LAUNCHES["layernorm_bwd"] == n0


# backbone family -> its Config fields
_FAMILIES = {
    "res18": dict(backbone_module="mmbev_resnet", backbone_name="mmbev_res18",
                  head_specify="DDIMDepthEstimate_Res"),
    "mpvit_tiny": dict(backbone_module="mpvit", backbone_name="mpvit_tiny",
                       head_specify="DDIMDepthEstimate_MPVIT_ADDHAHI",
                       head_in_channels="96,176,216,216"),
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_family_launch_counts(dev, family):
    """Under the bf16 policy on the card, 2 DDIM steps on a 64x96 batch of
    2: both heads take the fused chain, n links (the Res head's 'add' 4,
    the MPViT head's 'upsample_add' 6): n K1 + 1 K3 per eval step, and in
    training per sampler step n K1 + K2 forward and n K1 + K6 + n K5
    backward, plus the ddim_loss call's n K1 and its backward's n K1 + n
    K5. One K1 of each n, the transformed 256-channel link (pr0 or fa),
    takes the transform-warp path (conv_link_xf). No attention or
    LayerNorm kernel runs on either."""
    steps = 2
    cfg = port.Config(model_name="Diffusion_DCbase_", inference_steps=steps, opt_level="O1",
                      batch_size=2, **_FAMILIES[family]).finalize()
    model = port.build_model(cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {"rgb": torch.randn(2, 64, 96, 3, generator=g, device=dev),
             "gt": torch.rand(2, 64, 96, 1, generator=g, device=dev) * 8 + 1}
    links = 6 if family == "mpvit_tiny" else 4
    port.reset_launch_counts()
    pred, met, _ = port.make_eval_step(model)(batch, generator=g)
    torch.cuda.synchronize()
    want = {k: 0 for k in LAUNCHES}
    want.update(conv_link=links * steps, conv_link_xf=steps, ddim_step=steps)
    assert dict(LAUNCHES) == want
    assert bool(torch.isfinite(pred).all()) and bool(torch.isfinite(met).all())

    step = port.make_train_step(model, port.LossComputer(cfg),
                                port.make_optimizer(cfg, 10, model))
    port.reset_launch_counts()
    loss, _, _ = step(batch, generator=g)
    torch.cuda.synchronize()
    want = {k: 0 for k in LAUNCHES}
    want.update(conv_link=2 * links * (steps + 1), conv_link_xf=2 * (steps + 1),
                sched_step=steps, conv_link_bwd=links * (steps + 1), sched_bwd=steps)
    assert dict(LAUNCHES) == want
    assert bool(torch.isfinite(loss))


def test_add_chain_pr0_at_res50_shape(dev):
    """The 'add' chain's pr0 link at the res50 cell's latent (8 x 176 x 608,
    256 -> 64 channels): K1 with GN_IN | RELU | ADD | TE | STATS and K5
    with GN_NEXT | GN_IN | ADD | TE, each against its plain version with
    the tolerances and bitwise repeats of the tests above."""
    test_conv_link_matches_plain(dev, 256, 64, True, True, True, 8, 176, 608)
    test_conv_link_bwd_matches_plain(dev, 256, 64, True, True, True, 8, 176, 608)


# the six links of the chain for K1 (cin, cout, gn, add, stats) and K5
# (cin, cout, gn_next, gn_in, add), as in the tests above
_K1_LINKS = [(16, 64, False, False, True), (64, 256, True, False, True),
             (256, 256, True, True, False), (256, 256, False, False, False),
             (256, 64, False, False, True), (64, 16, True, False, True)]
_K5_LINKS = [(16, 64, True, False, False), (64, 256, True, True, False),
             (256, 256, False, True, True), (256, 256, False, False, False),
             (256, 64, True, False, False), (64, 16, True, True, False)]


@pytest.mark.parametrize("B,H,w", [(8, 88, 304), (4, 88, 226)], ids=["serve-x4", "train-x4"])
def test_x4_latent_kernels_match_plain(dev, B, H, w):
    """The Diffusion_DCx4base_ latents, a quarter of the image: (8, 88, 304)
    at serve (304 = 2 x 128 + 48 pixels a row), (4, 88, 226) for a
    training micro-batch of 352x904 crops (226 = 128 + 98). K1 and K5 at
    each of the six links with the tolerances and bitwise repeats of the
    tests above; K3, K2 and K6 on the 16-channel latent with theirs."""
    for link in _K1_LINKS:
        test_conv_link_matches_plain(dev, *link, B, H, w)
    for link in _K5_LINKS:
        test_conv_link_bwd_matches_plain(dev, *link, B, H, w)
    g = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16
    u6 = _rand(g, dev, B, H, w, 16, dtype=bf)
    x = _rand(g, dev, B, H, w, 16)
    a, b = 1 + _rand(g, dev, B, 16, scale=0.1), _rand(g, dev, B, 16, scale=0.1)
    sched = torch.tensor([0.3, 0.954, 0.5, 0.866], device=dev)
    out, ref = fd.ddim_step(u6, a, b, x, sched), fd.ddim_step_plain(u6, a, b, x, sched)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    xp, xpb = fd.sched_step(u6, a, b, x, sched)
    rp, rpb = fd.sched_step_plain(u6, a, b, x, sched)
    assert (xp - rp).abs().max() <= 1e-5 * rp.abs().max()
    assert (xpb.float() - rpb.float()).abs().max() <= 1e-2 * rp.abs().max()
    dxp, dxpb = _rand(g, dev, B, H, w, 16), _rand(g, dev, B, H, w, 16, dtype=bf)
    coefs = _coefs(g, dev, B, 16)
    dx, t6, ps = fd.sched_bwd(dxp, dxpb, u6, coefs, sched)
    rdx, rt6, rps = fd.sched_bwd_plain(dxp, dxpb, u6, coefs, sched)
    torch.cuda.synchronize()
    assert (dx - rdx).abs().max() <= 1e-5 * rdx.abs().max()
    assert (t6.float() - rt6.float()).abs().max() <= 1e-2 * rt6.float().abs().max()
    assert (ps.sum(1) - rps.sum(1)).abs().max() <= 1e-4 * rps.sum(1).abs().max()


@pytest.mark.parametrize("model_name,head", [
    ("Diffusion_DCx4base_", "DDIMDepthEstimate_Swin_ADDHAHI"),
    ("Diffusion_DCbase_", "DDIMDepthEstimate_Swin")], ids=["x4", "bins"])
def test_x4_and_concat_launch_counts(dev, model_name, head):
    """swin_micro (5 blocks) under the bf16 policy, 2 DDIM steps on a 64x96
    batch of 2. The X4 model's latent (16 x 24) takes the fused chain: per
    eval step 6 K1 + 1 K3, in training per sampler step 6 K1 + K2 forward
    and 6 K1 + K6 + 6 K5 backward, plus the ddim_loss call's 6 K1 and its
    backward's 6 K1 + 6 K5, one K1 of each 6 (fa) on the transform-warp
    path (conv_link_xf). The concat head runs its denoiser on cuDNN: no
    K1-K3, K5 or K6. Both run K4 once a block, again in the
    rematerialised backward, and K7 once a block."""
    steps, blocks = 2, 5
    cfg = port.Config(model_name=model_name, backbone_module="swin",
                      backbone_name="swin_micro", head_specify=head, inference_steps=steps,
                      opt_level="O1", batch_size=2,
                      head_in_channels="32,64,128,256").finalize()
    model = port.build_model(cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {"rgb": torch.randn(2, 64, 96, 3, generator=g, device=dev),
             "gt": torch.rand(2, 64, 96, 1, generator=g, device=dev) * 8 + 1}
    chain = model_name == "Diffusion_DCx4base_"
    port.reset_launch_counts()
    pred, met, _ = port.make_eval_step(model)(batch, generator=g)
    torch.cuda.synchronize()
    want = {k: 0 for k in LAUNCHES}
    want["window_attention"] = blocks
    if chain:
        want.update(conv_link=6 * steps, conv_link_xf=steps, ddim_step=steps)
    assert dict(LAUNCHES) == want
    assert bool(torch.isfinite(pred).all()) and bool(torch.isfinite(met).all())

    step = port.make_train_step(model, port.LossComputer(cfg),
                                port.make_optimizer(cfg, 10, model))
    port.reset_launch_counts()
    loss, _, _ = step(batch, generator=g)
    torch.cuda.synchronize()
    want = {k: 0 for k in LAUNCHES}
    want.update(window_attention=2 * blocks, window_attention_bwd=blocks)
    if chain:
        want.update(conv_link=2 * 6 * (steps + 1), conv_link_xf=2 * (steps + 1),
                    sched_step=steps, conv_link_bwd=6 * (steps + 1), sched_bwd=steps)
    assert dict(LAUNCHES) == want
    assert bool(torch.isfinite(loss))


def _op_cases(dev):
    """(name, operator, CUDA implementation, args) of the four operators
    at small ragged shapes on the card."""
    g = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16

    def r(*s, dtype=torch.float32, scale=1.0):
        return (torch.randn(s, generator=g, device=dev) * scale).to(dtype)

    x, add = r(2, 3, 130, 64, dtype=bf), r(2, 3, 130, 64, dtype=bf)
    w = r(3, 3, 64, 64, dtype=bf, scale=0.05)
    a, o = 1 + r(2, 64, scale=0.1), r(2, 64, scale=0.1)
    te = r(2, 64, dtype=bf, scale=0.1)
    u6, lat = r(2, 5, 7, 16, dtype=bf), r(2, 5, 7, 16)
    sched = torch.tensor([0.3, 0.954, 0.5, 0.866], device=dev)
    qkv, bias = r(2, 3, 49, 3 * 64, dtype=bf), r(2, 49, 49)
    mask = r(3, 49, 49)
    q, k, v = (r(2, 3, 2, 49, 32, dtype=bf) for _ in range(3))
    ops = torch.ops.diffusiondepth
    return [
        ("conv_link", ops.conv_link.default, fd.conv_link_cuda,
         (x, w, r(64), a, o, True, add, te, True)),
        ("conv_link", ops.conv_link.default, fd.conv_link_cuda,
         (x, w, r(64), None, None, False, None, None, False)),
        ("ddim_step", ops.ddim_step.default, fd.ddim_step_cuda,
         (u6, a[:, :16].contiguous(), o[:, :16].contiguous(), lat, sched)),
        ("window_attention", ops.window_attention.default, wa.window_attention_cuda,
         (qkv, bias, mask, 0.17, 2)),
        ("window_attention_split", ops.window_attention_split.default,
         wa.window_attention_split_cuda, (q, k, v, bias, mask, 0.17)),
    ]


def test_ops_match_direct_launch(dev):
    """Each operator on the card equals its CUDA implementation called
    directly, bit for bit, and counts one launch per call."""
    for name, op, direct, args in _op_cases(dev):
        n0 = LAUNCHES[name]
        got = op(*args)
        assert LAUNCHES[name] == n0 + 1, name
        want = direct(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a_, b_ in zip(got, want):
            if b_ is None:  # conv_link without stats: the operator's empty partials
                assert a_.numel() == 0, name
            else:
                assert torch.equal(a_, b_), name


def test_exported_flagship_matches_eager(dev, tmp_path):
    """swin_micro under the flagship head (bf16, 2 steps, 64x96): the
    exported predict step, saved and loaded, equals the eager step bit for
    bit on the card, with the eager path's K1 (fa's on the transform-warp
    path), K3 and K4 launches."""
    from diffusiondepth_tpu_torch.tools import export_model as em

    cfg = port.Config(model_name="Diffusion_DCbase_", backbone_module="swin",
                      backbone_name="swin_micro", inference_steps=2, opt_level="O1",
                      head_in_channels="32,64,128,256").finalize()
    model = port.build_model(cfg)
    spec = em.serving_batch_spec(2, 64, 96)
    path = str(tmp_path / "micro.pt2")
    em.save_exported(em.export_predict(model, spec), path)
    module = em.load_exported(path).module()
    g = torch.Generator(device=dev).manual_seed(3)
    batch = {k: torch.rand(s, generator=g, device=dev) * 5 for k, s in spec.items()}
    lat = torch.randn(em.latent_shape(model, 2, 64, 96), generator=g, device=dev)
    with torch.no_grad():
        want = em.make_predict_fn(model)(batch, lat)
        port.reset_launch_counts()
        got = module(batch, lat)
        torch.cuda.synchronize()
    assert LAUNCHES["conv_link"] == 12 and LAUNCHES["ddim_step"] == 2
    assert LAUNCHES["conv_link_xf"] == 2
    assert LAUNCHES["window_attention"] == 5
    assert torch.equal(got, want)


def test_msda_core_matches_cpu(dev):
    """The MSDA core (``F.grid_sample`` level by level, no kernel of the
    port's own) at one image of the serve cross-attention: 26752 level-0
    queries into the three fused levels of a 352x1216 Swin-L pyramid, 8
    heads of 64, 8 points, locations in [-0.1, 1.1]. f32 card against CPU
    within 1e-4 of the largest value (sums in another order). bf16 runs
    on the card in bf16, no cast (the path the module takes under O1):
    against the f32 core on the CPU from the same bf16 values (its grid
    the bf16 grid the card samples with) within 2e-2 of the largest value
    (bf16 products and output); its backward gives finite bf16 gradients
    by value, locations and weights."""
    from diffusiondepth_tpu_torch.ops.msda import ms_deform_attn

    lv = ((44, 152), (22, 76), (11, 38))
    nv, nq = sum(h * w for h, w in lv), 88 * 304
    g = torch.Generator().manual_seed(0)
    value = torch.randn(1, nv, 8, 64, generator=g)
    loc = torch.rand(1, nq, 8, 3, 8, 2, generator=g) * 1.2 - 0.1
    wts = torch.rand(1, nq, 8, 3, 8, generator=g) / 24
    ref = ms_deform_attn(value, lv, loc, wts)
    out = ms_deform_attn(value.to(dev), lv, loc.to(dev), wts.to(dev)).cpu()
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()

    bf = torch.bfloat16
    ins = [t.to(bf) for t in (value, loc, wts)]
    # f32 locations whose f32 grid 2 * loc - 1 is the bf16 path's grid
    loc_q = ((2.0 * ins[1] - 1.0).float() + 1.0) / 2.0
    ref_b = ms_deform_attn(ins[0].float(), lv, loc_q, ins[2].float())
    card = [t.to(dev).requires_grad_() for t in ins]
    out_b = ms_deform_attn(card[0], lv, card[1], card[2])
    assert out_b.dtype == bf and out_b.shape == (1, nq, 512)
    err = (out_b.detach().float().cpu() - ref_b).abs().max()
    assert err <= 2e-2 * ref_b.abs().max(), (err, ref_b.abs().max())
    out_b.float().square().sum().backward()
    for t in card:
        assert t.grad.dtype == bf and bool(torch.isfinite(t.grad).all()) and t.grad.abs().max() > 0
