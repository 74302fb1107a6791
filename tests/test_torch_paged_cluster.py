"""The paged-attention kernel's plan (``cluster_size``, ``block_pages``,
``rank_pages``, ``warp_pages``) and its split-and-merge, emulated in torch
on the CPU: each cluster rank takes a run of the row's pages (at least one
of the reference's 128-token K blocks) with one max over it, each warp
every 4th page of the run; the warps' sums add up in warp order and the
ranks' meet in rank order, rescaled to the row's max, as
``csrc/paged_attention.cu`` does.  The emulation
is held against the port's ``paged_attn_plain`` and the reference's
``_paged_attn_blocked`` for dense, int8 and packed-int4 pools, at the
reference's tolerance (tests/test_paged_attention.py: rtol 2e-5, atol
2e-6)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import _paged_attn_blocked  # noqa: E402

from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.quant.kvcache import kv_mode_of, quantize_kv  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-6)
NEG_INF = tpa.NEG_INF


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Hkv,P,sms,want", [
    (4, 16, 32, 132, 4),        # the main path: 256 blocks, 2 per SM
    (4, 16, 127, 132, 4),       # the serve's table: the same grid
    (1, 16, 127, 132, 8),       # capped at the portable cluster size
    (1, 2, 3, 132, 3),          # no more ranks than pages
    (64, 16, 127, 132, 1),      # a large batch fills the card alone
    (4, 2, 9, 132, 8)])
def test_cluster_size(B, Hkv, P, sms, want):
    assert tpa.cluster_size(B, Hkv, P, sms) == want


def test_cluster_size_ignores_lens_and_grid_stays_fixed():
    """The grid (B, Hkv, CL) depends on the table's width only through the
    cap CL <= P, so P = 32 and the serve's P = 127 launch the same grid."""
    assert tpa.cluster_size(4, 16, 32, 132) == tpa.cluster_size(4, 16, 127, 132)
    assert all(tpa.cluster_size(4, 16, P, 132) <= tpa.MAX_CLUSTER
               for P in range(1, 300))


@pytest.mark.parametrize("length,Sq,ps,want", [
    (0, 1, 16, 1), (15, 1, 16, 1), (16, 1, 16, 2), (288, 1, 16, 19),
    (0, 3, 16, 1), (14, 3, 16, 2), (2031, 1, 16, 127)])
def test_pages_used(length, Sq, ps, want):
    assert tpa.pages_used(length, Sq, ps) == want


@pytest.mark.parametrize("ps,bp", [(16, 8), (8, 16), (4, 32), (256, 1)])
def test_block_pages_is_the_reference_block(ps, bp):
    assert tpa.block_pages(ps) == bp


@pytest.mark.parametrize("bp", [1, 8])
@pytest.mark.parametrize("cl", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("nb", [1, 2, 5, 7, 19, 26, 32, 127])
def test_rank_runs_cover_the_row_in_order(nb, cl, bp):
    """Rank runs are contiguous, disjoint, in rank order and cover [0, nb);
    each holds max(bp, ceil(nb / cl)) pages until the row ends, so ranks
    past the row's last page are empty; each warp takes every 4th page of
    its rank's run, and the warps cover the run."""
    runs = [tpa.rank_pages(nb, cl, z, bp) for z in range(cl)]
    assert runs[0][0] == 0 and runs[-1][1] == nb
    for (b0, e0), (b1, e1) in zip(runs, runs[1:]):
        assert e0 == b1 and b0 <= e0 and b1 <= e1
    per = max(bp, -(-nb // cl))
    for z, (b, e) in enumerate(runs):
        assert e - b == max(0, min(per, nb - z * per))
        pages = sorted(p for w in range(tpa.WARPS)
                       for p in tpa.warp_pages(b, e, w))
        assert pages == list(range(b, e))


def test_empty_ranks_at_the_serve_shape():
    """The serve's rows hold at most 288 tokens (19 pages of 16, three of
    the reference's 8-page K blocks): with CL = 4 ranks 0-2 take a block
    each and rank 3 is empty; a 1-token row leaves ranks 1..3 empty; a row
    filling the 127-page table splits into runs of 32."""
    cl = tpa.cluster_size(4, 16, 127, 132)
    bp = tpa.block_pages(16)
    assert [tpa.rank_pages(19, cl, z, bp) for z in range(cl)] == [
        (0, 8), (8, 16), (16, 19), (19, 19)]
    assert [tpa.rank_pages(1, cl, z, bp) for z in range(cl)] == [
        (0, 1), (1, 1), (1, 1), (1, 1)]
    assert [tpa.rank_pages(127, cl, z, bp) for z in range(cl)] == [
        (0, 32), (32, 64), (64, 96), (96, 127)]


@pytest.mark.parametrize("D,mode,dtype,ok", [
    (64, "bf16", torch.float32, True), (64, "bf16", torch.bfloat16, True),
    (64, "int8", torch.float32, True), (64, "int4", torch.float32, True),
    (32, "int4", torch.float32, True), (128, "bf16", torch.float32, True),
    (256, "bf16", torch.bfloat16, True), (256, "bf16", torch.float32, False),
    (16, "int4", torch.float32, False), (8, "int8", torch.float32, False),
    (18, "bf16", torch.float32, False), (33, "int4", torch.float32, False),
    (20, "bf16", torch.float32, True)])
def test_kernel_takes(D, mode, dtype, ok):
    assert tpa.kernel_takes(D, mode, dtype) is ok


# ---------------------------------------------------------------------------
# the split and the merges, emulated
# ---------------------------------------------------------------------------

def cluster_emulation(q, pool_k, pool_v, pages, lens, window, *, scale, cap,
                      G, cl, scale_k=None, scale_v=None):
    """The kernel's order over whole pages: rank z of ``cl`` takes
    ``rank_pages`` (at least one reference K block), warp w ``warp_pages``
    of that run.  Each rank takes one max over its pages' scores, and its
    warps add up ``p = exp(s - max)`` (masked keys add 0) and ``p · v`` in
    warp order; the ranks meet in rank order, each rescaled from its max to
    the row's, and the sums divide by max(l, 1e-30)."""
    B, S, Hq, D = q.shape
    ps, Hkv = pool_k.shape[1], pool_k.shape[2]
    P = pages.shape[1]
    mode = kv_mode_of(pool_k)
    R = S * G
    bp = tpa.block_pages(ps)
    qg = (q * torch.tensor(scale, dtype=q.dtype)).reshape(
        B, S, Hkv, G, D).permute(0, 2, 1, 3, 4).reshape(B, Hkv, R, D).float()
    rq = torch.arange(R) // G
    t0 = torch.arange(ps)
    neg = torch.tensor(NEG_INF)
    out = torch.empty(B, Hkv, R, D)

    def block(pool, scale_rows, p, b):
        pid = int(pages[b, p]) if p < P else 0
        sc = None if scale_rows is None else scale_rows[pid]
        return tpa._dequant_block(pool[pid], sc, mode)

    for b in range(B):
        ln = int(lens[b])
        nb = tpa.pages_used(ln, S, ps)
        ranks = []
        for z in range(cl):
            begin, end = tpa.rank_pages(nb, cl, z, bp)
            scores = {}
            for p in range(begin, end):
                s = tpa._softcap(torch.einsum(
                    "hrd,thd->hrt", qg[b], block(pool_k, scale_k, p, b)), cap)
                dist = ln + rq[:, None] - (p * ps + t0)[None, :]
                ok = ((dist >= 0) & (dist < window))[None]
                scores[p] = torch.where(ok, s, neg)
            m = torch.full((Hkv, R), NEG_INF)
            for s in scores.values():
                m = torch.maximum(m, s.amax(-1))
            l = torch.zeros((Hkv, R))
            acc = torch.zeros((Hkv, R, D))
            for w in range(tpa.WARPS):
                lw = torch.zeros((Hkv, R))
                aw = torch.zeros((Hkv, R, D))
                for p in tpa.warp_pages(begin, end, w):
                    s = scores[p]
                    pe = torch.where(s == NEG_INF, torch.tensor(0.0),
                                     torch.exp(s - m[..., None]))
                    lw = lw + pe.sum(-1)
                    aw = aw + torch.einsum("hrt,thd->hrd", pe,
                                           block(pool_v, scale_v, p, b))
                l, acc = l + lw, acc + aw
            ranks.append((m, l, acc))
        mt = ranks[0][0]
        for m, _, _ in ranks[1:]:
            mt = torch.maximum(mt, m)
        l = torch.zeros((Hkv, R))
        acc = torch.zeros((Hkv, R, D))
        for m, lz, az in ranks:
            w = torch.exp(m - mt)
            l = l + lz * w
            acc = acc + az * w[..., None]
        out[b] = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.reshape(B, Hkv, S, G, D).permute(0, 2, 1, 3, 4)
    return out.reshape(B, S, Hq, D).to(q.dtype)


def _case(seed, mode, B, Sq, Hq, Hkv, D, ps, P):
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * P
    pk = torch.from_numpy(rng.normal(size=(n_pages, ps, Hkv, D)).astype(
        np.float32))
    pv = torch.from_numpy(rng.normal(size=(n_pages, ps, Hkv, D)).astype(
        np.float32))
    sk = sv = None
    if mode != "bf16":
        pk, sk = quantize_kv(pk, mode)
        pv, sv = quantize_kv(pv, mode)
    pages = torch.from_numpy(np.stack(
        [1 + b * P + rng.permutation(P) for b in range(B)]).astype(np.int32))
    q = torch.from_numpy(rng.normal(size=(B, Sq, Hq, D)).astype(np.float32))
    return q, pk, pv, pages, sk, sv


def _jax_blocked(q, pk, pv, pages, lens, window, *, scale, cap, G, sk, sv):
    j = lambda t: None if t is None else jnp.asarray(t.numpy())  # noqa: E731
    return np.asarray(_paged_attn_blocked(
        j(q), j(pk), j(pv), j(pages), j(lens), window, scale=scale, cap=cap,
        G=G, scale_k=j(sk), scale_v=j(sv)))


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("Sq,Hq,Hkv,window,cap,cl", [
    (1, 4, 4, None, None, 4),        # MHA, R = 1: the main path's layout
    (1, 4, 2, None, None, 3),        # GQA, a rank count that leaves a
    (1, 4, 2, 11, 25.0, 8),          # short last run; window + softcap
    (3, 4, 2, None, None, 2),        # Sq = 3 folded into the group axis
    (2, 2, 1, 9, None, 1)])          # MQA, one rank
def test_cluster_emulation_matches_plain_and_reference(mode, Sq, Hq, Hkv,
                                                       window, cap, cl):
    ps, P, D = 8, 9, 32
    lens = np.asarray([0, 1, ps - 1, ps, 5 * ps + 3, P * ps - Sq], np.int32)
    q, pk, pv, pages, sk, sv = _case(Sq * 10 + Hq + Hkv + cl, mode,
                                     len(lens), Sq, Hq, Hkv, D, ps, P)
    ln = torch.from_numpy(lens)
    win = tpa._NO_WINDOW if window is None else window
    kw = dict(scale=D ** -0.5, cap=cap, G=Hq // Hkv)
    emu = cluster_emulation(q, pk, pv, pages, ln, win, cl=cl, scale_k=sk,
                            scale_v=sv, **kw)
    plain = tpa.paged_attn_plain(q, pk, pv, pages, ln, win, scale_k=sk,
                                 scale_v=sv, **kw)
    ref = _jax_blocked(q, pk, pv, pages, ln, win, sk=sk, sv=sv, **kw)
    assert bool(torch.isfinite(emu).all())
    np.testing.assert_allclose(emu.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(emu.numpy(), ref, **TOL)


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_cluster_emulation_serve_table(mode):
    """The serve's shape in small: a 127-page table, rows idle (lens 0),
    short, and filling the whole table, with the main path's cluster size;
    positions past the table would read scratch page 0."""
    ps, P, D, Hq = 4, 127, 32, 4
    lens = np.asarray([0, 7, 100, P * ps - 1], np.int32)
    q, pk, pv, pages, sk, sv = _case(3, mode, len(lens), 1, Hq, Hq, D, ps, P)
    ln = torch.from_numpy(lens)
    cl = tpa.cluster_size(len(lens), Hq, P, 132)
    kw = dict(scale=D ** -0.5, cap=None, G=1)
    emu = cluster_emulation(q, pk, pv, pages, ln, tpa._NO_WINDOW, cl=cl,
                            scale_k=sk, scale_v=sv, **kw)
    plain = tpa.paged_attn_plain(q, pk, pv, pages, ln, tpa._NO_WINDOW,
                                 scale_k=sk, scale_v=sv, **kw)
    np.testing.assert_allclose(emu.numpy(), plain.numpy(), **TOL)


def test_cluster_emulation_bf16_q_and_pools():
    """bf16 q and pools: q scaled in bf16, one rounding of the output."""
    ps, P, D = 8, 6, 32
    lens = np.asarray([0, 13, P * ps - 1], np.int32)
    q, pk, pv, pages, _, _ = _case(9, "bf16", len(lens), 1, 4, 2, D, ps, P)
    q, pk, pv = (t.to(torch.bfloat16) for t in (q, pk, pv))
    ln = torch.from_numpy(lens)
    kw = dict(scale=D ** -0.5, cap=None, G=2)
    emu = cluster_emulation(q, pk, pv, pages, ln, tpa._NO_WINDOW, cl=4, **kw)
    plain = tpa.paged_attn_plain(q, pk, pv, pages, ln, tpa._NO_WINDOW, **kw)
    assert emu.dtype == torch.bfloat16
    np.testing.assert_allclose(emu.float().numpy(), plain.float().numpy(),
                               rtol=8e-3, atol=1e-6)
