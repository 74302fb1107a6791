"""Serving reduced phi-3-vision-4.2b (vlm) and whisper-large-v3 (encdec)
over a mesh (gloo, the CPU), and the rules by which ``shard_params``
cuts them and deepseek-v3-671b.

A 1x2 and a 2x1 mesh over two ranks (spawned once for the module) and a
2x2 mesh over four (spawned once) run ``generate(mesh=)`` on phi-3-vision
with an ``img`` and on whisper with 24 frames of ``enc_x``, fp and
``--mac int8``, and the static engine (``ServeEngine(mesh=)``) on both,
fp.  At a model axis of 2 each rank runs 2 of the 4 heads of every
attention (whisper's encoder and decoder self-attention, its
cross-attention and cross K/V) and half of every MLP; the ``img`` and
``enc_x`` rows reach the prefill whole on every model rank, split over
the data rows with their requests.  The tokens are token for token the
JAX package's single-device ``generate``/``ServeEngine`` and the port's
single rank, and every rank holds the same tokens.

The rule test holds every leaf dim ``shard_params`` cuts of the three
reduced trees against the ``"model"`` entry of the reference's rule for
the leaf's stacked path (``repro.parallel.sharding.rule_for_path``; the
stacked layout puts it one dim on), and the serving cache rules against
``_CACHE_RULES``.  No rank process imports JAX.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

PHI, WHISPER, DSV3 = ("phi-3-vision-4.2b", "whisper-large-v3",
                      "deepseek-v3-671b")
MESHES = ("1x2", "2x1", "2x2")
# (arch, MAC mode, entry point)
CASES = ((PHI, "fp", "generate"), (PHI, "fp", "static"),
         (WHISPER, "fp", "generate"), (WHISPER, "int8", "generate"),
         (WHISPER, "fp", "static"))
B, PROMPT, ENC_LEN, MAX_NEW = 4, 20, 24, 6


def _key(case):
    return "-".join(case)


def _inputs(cfg):
    """The prompts (B, PROMPT), a static trace of ragged prompts, and the
    arch's ``extras`` (an ``img`` or ``enc_x``), from a seed."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 512, (B, PROMPT)).astype(np.int32)
    trace = [rng.integers(0, 512, n).astype(np.int32)
             for n in (20, 9, 17, 13)]
    extras = {}
    if cfg.n_patches:
        extras["img"] = rng.normal(size=(B, cfg.n_patches, cfg.d_model)
                                   ).astype(np.float32)
    if cfg.family == "encdec":
        extras["enc_x"] = rng.normal(size=(B, ENC_LEN, cfg.d_model)
                                     ).astype(np.float32)
    return prompts, trace, extras


def _tcfg(arch, mode):
    from repro_torch.configs import get_config
    from repro_torch.core.layers import MacConfig
    return dataclasses.replace(get_config(arch).reduced(),
                               mac=MacConfig(mode=mode))


def _serve(params, case, mesh=None):
    from repro_torch.serve import ServeEngine, generate
    arch, mode, entry = case
    cfg = _tcfg(arch, mode)
    prompts, trace, extras = _inputs(cfg)
    if entry == "static":
        eng = ServeEngine(params, cfg, batch_slots=B, device="cpu",
                          mesh=mesh)
        return [o.tolist() for o in eng.run(trace, max_new=MAX_NEW)]
    return generate(params, cfg, prompts, MAX_NEW, extras=extras,
                    mesh=mesh).tolist()


def _rank(mesh, trees):
    """Every case on this rank, at the spawned mesh and (two ranks) at a
    2x1 mesh of the same ranks: tokens and the ranks' agreement."""
    import torch.distributed as dist
    from repro_torch.parallel.mesh import Mesh
    meshes = {f"{mesh.n_data}x{mesh.n_model}": mesh}
    if dist.get_world_size() == 2:
        meshes["2x1"] = Mesh(2, 1)
    out = {}
    for tag, m in meshes.items():
        for case in CASES:
            toks = _serve(trees[case[:2]], case, m)
            out[(tag, _key(case))] = {"tokens": toks, "agree": m.agree(toks)}
    return out


def _reference(jp, jcfg, case):
    import jax.numpy as jnp
    from repro.serve.engine import ServeEngine as JServe
    from repro.serve.engine import generate as jgen
    prompts, trace, extras = _inputs(jcfg)
    if case[2] == "static":
        return [np.asarray(o).tolist() for o in JServe(
            jp, jcfg, batch_slots=B).run(trace, max_new=MAX_NEW)]
    return np.asarray(jgen(jp, jcfg, jnp.asarray(prompts), MAX_NEW,
                           extras={k: jnp.asarray(v)
                                   for k, v in extras.items()})).tolist()


@pytest.fixture(scope="module")
def runs():
    """The reference's single-device tokens, the port's single rank's,
    the ranks' results by mesh."""
    import jax
    from repro.configs import get_config as jget
    from repro.core.layers import MacConfig as JMac
    from repro.models import init_model as j_init
    from repro_torch.models import params_from_jax
    from repro_torch.parallel.mesh import run_ranks
    jtrees, trees = {}, {}
    for arch, mode, _ in CASES:
        if (arch, mode) in trees:
            continue
        jcfg = dataclasses.replace(jget(arch).reduced(), mac=JMac(mode=mode))
        jp = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
        jtrees[(arch, mode)] = (jp, jcfg)
        trees[(arch, mode)] = params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), _tcfg(arch, mode), "cpu")
    # the ranks run while the reference serves here
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        two = ex.submit(run_ranks, _rank, 2, trees)
        four = ex.submit(run_ranks, _rank, 2, trees, n_data=2)
        want = {_key(case): _reference(*jtrees[case[:2]], case)
                for case in CASES}
        single = {_key(case): _serve(trees[case[:2]], case)
                  for case in CASES}
        ranks = two.result()
        ranks.update(four.result())
    return want, single, ranks


@pytest.mark.parametrize("case", CASES, ids=_key)
@pytest.mark.parametrize("mesh", MESHES)
def test_tokens_match_reference_and_single_rank(runs, mesh, case):
    want, single, ranks = runs
    assert single[_key(case)] == want[_key(case)]
    assert ranks[(mesh, _key(case))]["tokens"] == want[_key(case)]


@pytest.mark.parametrize("case", CASES, ids=_key)
@pytest.mark.parametrize("mesh", MESHES)
def test_ranks_agree(runs, mesh, case):
    assert runs[2][(mesh, _key(case))]["agree"]


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _stage_names(cfg):
    """The reference's stage name of each of the port's layers."""
    from repro_torch.models import layer_stages
    return [name for name, _, n in layer_stages(cfg) for _ in range(n)]


@pytest.mark.parametrize("arch", (DSV3, PHI, WHISPER))
def test_cut_dims_follow_the_reference_rules(arch):
    """Each leaf ``shard_params`` cuts at a model axis of 2 is cut on the
    dim the reference's rule for its stacked path names ``"model"`` (the
    layer axis first: the per-layer dim + 1), and each leaf it keeps
    whole has no ``"model"`` dim there; but for two stated cases: a
    column linear's fp bias ``_b``, which a rank adds to its n-slice (the
    reference keeps it whole, its rule's ``"model"`` entry falling past a
    1-D leaf or no rule matching, and adds it to a sharded output), and
    the MTP head, which serving never reads (whole on every rank; its
    rules are the training slice's)."""
    from repro.parallel.sharding import STACKED_STAGES, rule_for_path
    from repro_torch.analysis.shardcheck import LayoutMesh, leaf_paths
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.parallel.sharding import linear_role, shard_params
    cfg = get_config(arch).reduced()
    params = init_model(cfg, device="meta")
    local = dict(leaf_paths(shard_params(params, cfg, LayoutMesh(2))))
    stages = _stage_names(cfg)
    n_cut = 0
    for path, leaf in leaf_paths(params):
        got = [i for i, (a, b) in enumerate(zip(leaf.shape,
                                                local[path].shape)) if a != b]
        parts = path.split("/")
        if parts[0] == "layers":
            ref_path = "/".join([stages[int(parts[1])]] + parts[2:])
        else:
            ref_path = path
        stacked = ref_path.split("/", 1)[0] in STACKED_STAGES
        rule = rule_for_path(ref_path)
        items = list(() if rule is None or rule[1] is None
                     else rule[1])[:leaf.dim()]
        want = [i + stacked for i, e in enumerate(items) if e == "model"]
        mine = [i + stacked for i in got]
        key = parts[-1]
        if parts[0] == "mtp":
            assert mine == [], path
        elif (want == [] and mine == [stacked] and leaf.dim() == 1
              and key.endswith("_b")
              and linear_role(key[:-2]) == "column"):
            pass
        else:
            assert mine == want, (path, ref_path, mine, want)
        n_cut += bool(got)
    assert n_cut > 0


@pytest.mark.parametrize("name", ("k", "v", "ck", "cv", "ckv", "kr"))
def test_serving_cache_rules_against_the_reference(name):
    """Each serving cache leaf's data dim is the reference's batch dim
    (the stacked layout puts it one dim on); its model dim parts from the
    reference's, which cuts the sequence of every one: the dense and
    cross K/V hold the model axis's kv heads, the MLA latent none (whole
    on every model rank), the partings stated in ``SERVING_CACHE``."""
    from repro.parallel.sharding import AXIS_BATCH, AXIS_MODEL
    from repro.parallel.statesharding import _CACHE_RULES
    from repro_torch.parallel.statesharding import SERVING_CACHE
    ref = _CACHE_RULES[name]
    d_dim, m_dim = SERVING_CACHE[name]
    assert ref.index(AXIS_BATCH) == d_dim + 1
    assert ref.index(AXIS_MODEL) == 2             # (L, B, S, …): S
    assert m_dim == (None if name in ("ckv", "kr") else 2)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch, extra, mesh", [
    (DSV3, ["--mac", "encoded", "--encoding", "exact"], "2"),
    (PHI, [], "2x2"),
    (WHISPER, ["--mac", "int8"], "2x2"),
])
def test_cli_mesh_prints_the_single_rank_tokens(capfd, arch, extra, mesh):
    """``--mesh`` admits the three archs: rank 0 prints the tokens of the
    same command without it (deepseek-v3 at a model axis alone: at a data
    axis its MoE calls take their rows' capacity, which the CLI's ragged
    prompts make another serve)."""
    from repro_torch.launch import serve as tcli
    argv = ["--reduced", "--device", "cpu", "--arch", arch, "--requests",
            "4", "--max-new", "5"] + extra
    tcli.main(argv)
    alone = capfd.readouterr().out
    tcli.main(argv + ["--mesh", mesh])
    meshed = capfd.readouterr().out
    req = [ln for ln in alone.splitlines() if ln.startswith("req")]
    assert req and [ln for ln in meshed.splitlines()
                     if ln.startswith("req")] == req
    d, m = (mesh.split("x") if "x" in mesh else ("1", mesh))
    assert f"mesh: {{'data': {d}, 'model': {m}}} replicated=[]" in meshed
    assert meshed.count("served 4 requests") == 1
