"""Port parity for static-batch serving on the dense KV cache (reduced
qwen1.5-0.5b, fp and encoded-exact): the port's ``generate`` against the
reference's token for token (uniform batch, EOS with frozen rows and the
early exit, ragged left-padded rows), ``ServeEngine.run`` against the
reference's over a ragged trace, the port's paged ``Engine`` against its
own ``generate``, one dense decode step's cache rows against the
reference's (rtol = atol = 1e-4), the CLI's default (static) path, and
sampling with an explicit ``torch.Generator``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core.circuits import exact_product_circuit  # noqa: E402
from repro.core.encoding import EncodingSpec  # noqa: E402
from repro.core.mac import EncodedMac  # noqa: E402
from repro.models import apply_model as j_apply  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serve.encoded import prepare_encoded_serving as j_prepare  # noqa: E402
from repro.serve.engine import ServeEngine as JServe  # noqa: E402
from repro.serve.engine import generate as j_generate  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import apply_model as t_apply  # noqa: E402
from repro_torch.models import init_cache as t_init_cache  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve import (Engine as TEngine, ServeEngine as TServe,  # noqa: E402
                               exact_encodings, generate as t_generate,
                               prepare_encoded_serving, supports_ragged_mask)
from repro_torch.serve.engine import StaticBatch  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
VOCAB = 512


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    jcfg = jget("qwen1.5-0.5b").reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    circ, s = exact_product_circuit(8, 8)
    mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
    override = {n: mac for n in ("wq", "wk", "wv", "wo", "wi", "wg", "w")}
    jpe, jce, _ = j_prepare(jp, jcfg, macs_override=override,
                            cache_dir=str(tmp_path_factory.mktemp("b")),
                            verbose=False)
    tcfg = tget("qwen1.5-0.5b").reduced()
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    # the port calibrates and folds on its own, as the serving parity of
    # the continuous engine does (tests/test_torch_serve.py)
    tpe, tce, _ = prepare_encoded_serving(
        tp, tcfg, macs_override=exact_encodings(), device="cpu",
        cache_dir=str(tmp_path_factory.mktemp("own")), verbose=False)
    bridged = params_from_jax(jax.tree_util.tree_map(np.asarray, jpe), tcfg,
                              "cpu")
    return {"fp": ((jp, jcfg), (tp, tcfg), (tp, tcfg)),
            "encoded": ((jpe, jce), (tpe, tce), (bridged, tce))}


def _prompts(kind):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, VOCAB, (3, 21)).astype(np.int32)
    pad = None
    if kind == "ragged":
        pad = np.asarray([0, 7, 13], np.int32)
        for b, n in enumerate(pad):
            toks[b, :n] = 0
    return toks, pad


def _jax_tokens(jp, jcfg, toks, max_new, **kw):
    return np.asarray(j_generate(jp, jcfg, jnp.asarray(toks), max_new=max_new,
                                 **kw))


@pytest.mark.parametrize("mode", ["fp", "encoded"])
@pytest.mark.parametrize("kind", ["uniform", "eos", "ragged"])
def test_generate_matches_reference(models, mode, kind):
    (jp, jcfg), (tp, tcfg), _ = models[mode]
    toks, pad = _prompts(kind)
    max_new = 10
    kw = {}
    if kind == "eos":
        # an EOS that row 0 emits early: its row freezes, the others go on
        first = _jax_tokens(jp, jcfg, toks, max_new)
        kw["eos_id"] = int(first[0, 2])
    if pad is not None:
        kw["pad_lens"] = pad
    want = _jax_tokens(jp, jcfg, toks, max_new, **kw)
    got = t_generate(tp, tcfg, toks, max_new=max_new, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "eos":
        eos = kw["eos_id"]
        assert (got[0, 2:] == eos).all()


def test_generate_exits_early_when_every_row_ends(models):
    """All rows at EOS → fewer than max_new columns, as the reference."""
    (jp, jcfg), (tp, tcfg), _ = models["fp"]
    toks = np.repeat(_prompts("uniform")[0][:1], 2, axis=0)
    first = _jax_tokens(jp, jcfg, toks, 6)
    eos = int(first[0, 1])
    want = _jax_tokens(jp, jcfg, toks, 6, eos_id=eos)
    got = t_generate(tp, tcfg, toks, max_new=6, eos_id=eos).numpy()
    assert want.shape[1] == 2
    np.testing.assert_array_equal(got, want)


def _trace():
    rng = np.random.default_rng(4)
    return [rng.integers(0, VOCAB, n).astype(np.int32)
            for n in (9, 30, 17, 4, 25)]


@pytest.mark.parametrize("mode", ["fp", "encoded"])
@pytest.mark.parametrize("slots", [2, 3])
def test_serve_engine_matches_reference(models, mode, slots):
    (jp, jcfg), (tp, tcfg), _ = models[mode]
    trace = _trace()
    want = JServe(jp, jcfg, batch_slots=slots).run(trace, max_new=7)
    eng = TServe(tp, tcfg, batch_slots=slots, device="cpu")
    got = eng.run(trace, max_new=7)
    assert len(got) == len(want) == len(trace)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(i))
    st = eng.stats()
    n_chunks = -(-len(trace) // slots)
    assert st["chunks"] == n_chunks and st["requests"] == len(trace)
    # one prefill and max_new - 1 decode steps per chunk
    assert st["decode_steps"] == 6 * n_chunks
    assert st["tokens"] == 7 * len(trace)
    assert st["jit_compiles"] == 0 and not st["cuda_graphs"]
    assert len(eng.step_ms) == st["decode_steps"]


@pytest.mark.parametrize("mode", ["fp", "encoded"])
def test_paged_engine_matches_generate(models, mode):
    """Both of the port's engines give each request its solo tokens."""
    _, (tp, tcfg), _ = models[mode]
    tcfg = dataclasses.replace(tcfg, attention_backend="kernel")
    trace = _trace()
    eng = TEngine(tp, tcfg, device="cpu", n_slots=3, page_size=8,
                  n_pages=48, prefill_chunk=16)
    rids = [eng.submit(p, max_new=7) for p in trace]
    outs = eng.run()
    for rid, p in zip(rids, trace):
        solo = t_generate(tp, tcfg, p[None], max_new=7).numpy()[0]
        np.testing.assert_array_equal(outs[rid], solo, err_msg=str(rid))


@pytest.mark.parametrize("mode", ["fp", "encoded"])
@pytest.mark.parametrize("ragged", [False, True])
def test_dense_decode_step_cache_matches_reference(models, mode, ragged):
    """Prefill, then one decode step: logits and the cache rows written
    at ``pos`` agree with the reference's stacked ``(L, B, T, H, D)``
    cache, and both carry ``pos + 1``."""
    (jp, jcfg), _, (tp, tcfg) = models[mode]
    toks, pad = _prompts("ragged" if ragged else "uniform")
    B, S = toks.shape
    T = S + 4
    jc = j_init_cache(jcfg, B, T)
    tc = t_init_cache(tcfg, B, T, device="cpu")
    if ragged:
        jc["pad"] = jnp.asarray(pad)
        tc["pad"] = torch.from_numpy(pad)
    jl, jc, _ = j_apply(jp, jcfg, jnp.asarray(toks), cache=jc)
    with torch.inference_mode():
        tl, tc = t_apply(tp, tcfg, torch.from_numpy(toks), cache=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt = np.argmax(np.asarray(jl)[:, -1, :VOCAB], -1).astype(np.int32)
    jl, jc, _ = j_apply(jp, jcfg, jnp.asarray(nxt[:, None]), cache=jc)
    with torch.inference_mode():
        tl, tc = t_apply(tp, tcfg, torch.from_numpy(nxt[:, None]), cache=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(jc["pos"]) == int(tc["pos"]) == S + 1
    stack = jc["layers"]["stack"]
    for i, layer in enumerate(tc["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                layer[name][:, :S + 1].numpy(),
                np.asarray(stack[name][i])[:, :S + 1], **TOL)
            # past pos + 1 both caches are still zero
            assert not layer[name][:, S + 1:].any()


def test_cli_serves_static_by_default(capsys):
    from repro_torch.launch import serve as tcli
    tcli.main(["--reduced", "--device", "cpu", "--requests", "6",
               "--max-new", "8"])
    out = capsys.readouterr().out
    served = [ln for ln in out.splitlines() if ln.startswith("served")]
    assert len(served) == 1 and served[0].endswith("mac=fp, static)")
    assert "served 6 requests, 48 tokens" in served[0]
    assert sum(ln.startswith("req") for ln in out.splitlines()) == 3


@pytest.mark.parametrize("flag", [["--kv-dtype", "int8"],
                                  ["--spec-decode", "2"]])
def test_cli_refuses_paged_only_flags_without_continuous(flag):
    from repro_torch.launch import serve as tcli
    with pytest.raises(SystemExit):
        tcli.main(["--reduced", "--device", "cpu"] + flag)


def test_sampling_is_reproducible_and_in_vocab(models):
    _, (tp, tcfg), _ = models["fp"]
    toks, _ = _prompts("uniform")
    runs = [t_generate(tp, tcfg, toks, max_new=12, greedy=False,
                       generator=torch.Generator().manual_seed(7)).numpy()
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].shape == (3, 12)
    assert ((runs[0] >= 0) & (runs[0] < tcfg.vocab_size)).all()
    other = t_generate(tp, tcfg, toks, max_new=12, greedy=False,
                       generator=torch.Generator().manual_seed(8)).numpy()
    assert not np.array_equal(runs[0], other)
    with pytest.raises(ValueError, match="Generator"):
        t_generate(tp, tcfg, toks, max_new=3, greedy=False)


def test_pad_lens_refused_where_masking_is_not_exact(models):
    _, (tp, tcfg), _ = models["fp"]
    flash = dataclasses.replace(tcfg, flash_attention=True)
    assert supports_ragged_mask(tcfg) and not supports_ragged_mask(flash)
    toks, pad = _prompts("ragged")
    with pytest.raises(ValueError, match="pad_lens"):
        t_generate(tp, flash, toks, max_new=2, pad_lens=pad)
    # an all-zero pad_lens is a uniform batch: no refusal
    t_generate(tp, flash, toks, max_new=2, pad_lens=np.zeros(3, np.int32))


def test_cuda_graphs_need_the_card(models):
    _, (tp, tcfg), _ = models["fp"]
    with pytest.raises(ValueError, match="cuda_graphs"):
        TServe(tp, tcfg, device="cpu", cuda_graphs=True)


def test_serve_engine_builds_each_chunk_cache_anew(models):
    """Each chunk gets a cache of its own ``S + max_new + 8`` positions,
    dropped at the chunk's end: the engine holds none between runs, a
    second run serves the same tokens, and ``kv_cache_bytes`` is the
    largest chunk's cache."""
    _, (tp, tcfg), _ = models["fp"]
    trace = _trace()                     # chunks of 2: three shapes
    eng = TServe(tp, tcfg, batch_slots=2, device="cpu")
    first = eng.run(trace, max_new=4)
    assert not any(isinstance(v, StaticBatch) for v in vars(eng).values())
    again = eng.run(trace[:2], max_new=4)
    for a, b in zip(again, first[:2]):
        np.testing.assert_array_equal(a, b)
    st = eng.stats()
    assert st["chunks"] == 4 and st["jit_compiles"] == 0
    per_pos = (2 * tcfg.n_layers * tcfg.n_kv_p * tcfg.head_dim_r
               * torch.empty((), dtype=tcfg.cdtype).element_size())
    want = max(c["batch"] * c["max_len"] for c in eng.chunks) * per_pos
    assert st["kv_cache_bytes"] == want
    assert [c["max_len"] for c in eng.chunks[:3]] == [
        max(map(len, trace[i:i + 2])) + 4 + 8 for i in (0, 2, 4)]
