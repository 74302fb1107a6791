"""The serve CLI's ``--mesh`` on the CPU: ``--mesh 2`` spawns 2 ranks and
``--mesh 2x2`` 4 (a data axis of 2) and each prints (rank 0) the tokens
of the same command without it; the archs outside the dense family and
qwen3-moe are refused with an error naming the ROADMAP item; a rank
process imports neither JAX nor the JAX package; a rank that raises
takes the whole run down."""
import pytest

pytest.importorskip("torch")

from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.parallel.mesh import run_ranks  # noqa: E402

ARGV = ["--reduced", "--device", "cpu", "--continuous", "--mac", "encoded",
        "--encoding", "exact", "--requests", "4", "--max-new", "6"]


def _tokens(out: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith("req")]


def test_mesh_prints_the_single_rank_tokens(capfd):
    tcli.main(ARGV)
    alone = capfd.readouterr().out
    tcli.main(ARGV + ["--mesh", "2"])
    meshed = capfd.readouterr().out
    assert _tokens(alone) and _tokens(meshed) == _tokens(alone)
    assert "cache hit" in meshed
    assert "mesh: {'data': 1, 'model': 2} replicated=[]" in meshed
    assert meshed.count("served 4 requests") == 1       # rank 0 alone


@pytest.mark.parametrize("continuous", [True, False],
                         ids=["continuous", "static"])
def test_data_axis_prints_the_single_rank_tokens(capfd, continuous):
    argv = ["--reduced", "--device", "cpu", "--requests", "4",
            "--max-new", "6"] + (["--continuous"] if continuous else [])
    tcli.main(argv)
    alone = capfd.readouterr().out
    tcli.main(argv + ["--mesh", "2x2"])
    meshed = capfd.readouterr().out
    assert _tokens(alone) and _tokens(meshed) == _tokens(alone)
    assert ("mesh: {'data': 2, 'model': 2} replicated=[] data_split=True"
            in meshed)
    assert meshed.count("served 4 requests") == 1       # rank 0 alone


@pytest.mark.parametrize("extra, msg", [
    (["--mesh", "2x2", "--arch", "hymba-1.5b"], "not ported to tensor"),
    (["--mesh", "x2"], "expected 'M' or 'DxM'"),
    (["--mesh", "2", "--arch", "xlstm-1.3b"], "not ported to tensor"),
    (["--mesh", "2", "--arch", "hymba-1.5b"], "not ported to tensor"),
])
def test_mesh_refusals(capsys, extra, msg):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--reduced", "--device", "cpu"] + extra)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert msg in err and ("ROADMAP" in err or "DxM" in err)


def _imported(mesh):
    import sys
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def test_ranks_import_no_jax():
    assert run_ranks(_imported, 2, timeout=120) == []


def _boom(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one fails")
    mesh.barrier()


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank one fails"):
        run_ranks(_boom, 2, timeout=120)
