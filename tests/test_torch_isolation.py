"""The port stands alone: it imports neither ``jax`` nor ``repro``, its
entry points refuse to fall back to the CPU, and its kernel build refuses
to run without ``nvcc``."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread: the suite runs a process a core

from repro_torch.kernels import build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")


def _modules():
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax_and_no_reference():
    mods = list(_modules())
    assert {"repro_torch.launch.serve", "repro_torch.core.engine",
            "repro_torch.models.recsys.dlrm", "repro_torch.launch.steps",
            "repro_torch.launch.mesh", "repro_torch.distributed.sharding",
            "repro_torch.distributed.collectives", "repro_torch.training.optimizer",
            "repro_torch.data.loader", "repro_torch.checkpoint.manager",
            "repro_torch.launch.train", "repro_torch.tree", "repro_torch.models.moe",
            "repro_torch.configs.qwen3_8b", "repro_torch.configs.qwen1_5_110b",
            "repro_torch.configs.starcoder2_3b", "repro_torch.configs.granite_moe_1b_a400m",
            "repro_torch.configs.moonshot_v1_16b_a3b", "repro_torch.configs.bst",
            "repro_torch.configs.bert4rec", "repro_torch.configs.mind",
            "repro_torch.models.recsys.bst", "repro_torch.models.recsys.bert4rec",
            "repro_torch.models.recsys.mind", "repro_torch.distributed.compression",
            "repro_torch.distributed.cross_pod", "repro_torch.distributed.decode_attention",
            "repro_torch.distributed.pipeline"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
            " or n == 'repro' or n.startswith('repro.'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, check=True, timeout=300)
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("path", [*sorted(PORT.rglob("*.py")), ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_line_imports_jax_or_reference(path):
    bad = [ln for ln in path.read_text().splitlines() if IMPORT_RE.match(ln)]
    assert not bad


def test_import_pattern_spares_the_port():
    assert IMPORT_RE.match("import jax.numpy as jnp")
    assert IMPORT_RE.match("from repro.core import engine")
    assert IMPORT_RE.match("    import repro")
    assert not IMPORT_RE.match("from repro_torch.core import engine")
    assert not IMPORT_RE.match("import repro_torch")


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    from repro_torch.core import prng
    from repro_torch.data.synthetic import make_synthetic_ce
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_synthetic_ce(prng.PRNGKey(0), n_queries=4, n_items=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build_domain(100)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--n-items", "100", "--requests", "1"])
    assert resolve_device("cpu") == torch.device("cpu")
    assert make_synthetic_ce(prng.PRNGKey(0), n_queries=4, n_items=8,
                             device="cpu").i_emb.shape == (8, 16)


def test_index_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch, tmp_path):
    """Loading a saved index (``AnchorIndex.load``, ``Checkpointer.restore``,
    ``AdaCURService(index=<dir>)``) and folding BM25's weights land on the
    card unless the caller asks for the CPU: without a card they raise."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core.candidates import BM25Candidates
    from repro_torch.core.index import AnchorIndex
    from repro_torch.launch.serve import AdaCURService

    AnchorIndex.from_r_anc(torch.ones(4, 8)).save(str(tmp_path))
    tokens = np.arange(24, dtype=np.int32).reshape(8, 3) % 5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnchorIndex.load(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Checkpointer(str(tmp_path)).restore(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdaCURService(score_fn=lambda q, i: None, cfg=AdaCURConfig(), index=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BM25Candidates(tokens, tokens[:2])
    assert AnchorIndex.load(str(tmp_path), device="cpu").r_anc.device == torch.device("cpu")
    assert Checkpointer(str(tmp_path)).restore(0, device="cpu")["r_anc"].shape == (4, 8)


def test_router_and_faulty_services_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """A service over a ``FaultyScorer`` built from a bare ``r_anc`` lands on
    the card unless the caller asks for the CPU, and a ``Router`` over card
    services gives each replica a stream on that card: without a card both
    raise; CPU services take no streams."""
    from repro_torch.configs.base import AdaCURConfig
    from repro_torch.core.scorer import TabulatedScorer
    from repro_torch.launch.faults import FaultPlan, FaultyScorer
    from repro_torch.launch.router import Router
    from repro_torch.launch.serve import AdaCURService

    m = np.zeros((4, 8), np.float32)
    cfg = AdaCURConfig(k_anchor=2, n_rounds=2, budget_ce=4, k_retrieve=2, loop_mode="fori")
    faulty = FaultyScorer(TabulatedScorer(m), FaultPlan())
    svc = AdaCURService(score_fn=faulty, r_anc=m, cfg=cfg, device="cpu")
    router = Router([svc])
    try:
        assert router.replicas[0].stream is None
    finally:
        router.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdaCURService(score_fn=faulty, r_anc=m, cfg=cfg)
    monkeypatch.setattr(AdaCURService, "device", property(lambda self: torch.device("cuda")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Router([svc])


def test_real_ce_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    from repro_torch.configs.registry import CE_TINY
    from repro_torch.launch import serve
    from repro_torch.models.cross_encoder import init_cross_encoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cross_encoder(CE_TINY, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build_real_ce_domain(50, 4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--scorer", "real-ce", "--n-items", "50", "--requests", "1"])


def test_sharded_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch, tmp_path):
    """``make_serving_mesh``, ``AnchorIndex.load(path, mesh)`` over a card
    mesh and the CLI's ``--mesh`` land on the card unless the caller asks
    for the CPU: without a card they raise before any process group
    exists."""
    from repro_torch.core.index import AnchorIndex
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_serving_mesh

    class CardMesh:            # a card mesh's face, as load(path, mesh) reads it
        device_type = "cuda"
        mesh_dim_names = ("data", "items")
        shape = (1, 1)

    AnchorIndex.from_r_anc(torch.ones(4, 8)).save(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_serving_mesh(1, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnchorIndex.load(str(tmp_path), mesh=CardMesh())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--mesh", "1x1", "--batch", "4", "--requests", "1"])
    assert not torch.distributed.is_initialized()


def test_mesh_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch, tmp_path):
    """The sequence-parallel decode core, the expert-parallel MoE, the
    pipeline, the cross-pod reduce, the sharded save of an index over a
    card mesh, the replica meshes the router serves and the LM prefill and
    decode over a mesh land on the card unless the caller asks for the
    CPU: without a card they raise before any process group exists."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import LMShape, MoEConfig
    from repro_torch.core.index import AnchorIndex
    from repro_torch.launch import steps
    from repro_torch.distributed.cross_pod import make_hierarchical_grad_reduce
    from repro_torch.distributed.decode_attention import make_decode_core
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch.mesh import make_replica_meshes
    from repro_torch.models.moe import make_moe_fn

    class CardMesh:            # a card mesh's face
        device_type = "cuda"
        mesh_dim_names = ("data", "items")
        shape = (1, 1)

    index = AnchorIndex.from_r_anc(torch.ones(4, 8))
    sharded = AnchorIndex(**{**index.__dict__, "mesh": CardMesh(), "item_axes": ("items",)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: make_decode_core(CardMesh(), ("data",), ("items",), 8),
                 lambda: make_moe_fn(CardMesh(), MoEConfig(4, 2, 8), ("data",), "items"),
                 lambda: pipeline_forward(CardMesh(), lambda p, x: x, "data", 2),
                 lambda: make_hierarchical_grad_reduce(CardMesh()),
                 lambda: sharded.save(str(tmp_path / "sharded")),
                 lambda: make_replica_meshes(2, 1, 1),
                 lambda: steps.build_lm_prefill("g", registry.smoke_config(
                     "granite-moe-1b-a400m"), LMShape("p", "prefill", 8, 2), mesh=CardMesh()),
                 lambda: steps.build_lm_decode("g", registry.smoke_config(
                     "granite-moe-1b-a400m"), LMShape("d", "decode", 8, 2), mesh=CardMesh())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not torch.distributed.is_initialized()
    assert not (tmp_path / "sharded").exists()


def test_training_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch, tmp_path):
    """The train builders (the LM's over a mesh too), the trainer CLI, a
    checkpoint's restore into a training tree and
    ``CheckpointManager.resume`` land on the card unless the caller asks
    for the CPU: without a card they raise, before any process group
    exists."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.configs.base import LMShape, RecSysShape
    from repro_torch.launch import steps, train

    state = {"w": torch.ones(3), "opt": [torch.zeros(2)]}
    CheckpointManager(str(tmp_path), save_every=1, async_save=False).maybe_save(1, state)
    cfg = registry.smoke_config("dlrm-mlperf")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.build_recsys_train("dlrm-mlperf", cfg, RecSysShape("t", "train", 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.build_lm_train("ce-tiny", registry.CE_TINY, LMShape("t", "train", 8, 2))

    class CardMesh:            # a card mesh's face
        device_type = "cuda"
        mesh_dim_names = ("data", "model")
        shape = (2, 2)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.build_lm_train("g", registry.smoke_config("granite-moe-1b-a400m"),
                             LMShape("t", "train", 8, 2), mesh=CardMesh())
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "cli")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CheckpointManager(str(tmp_path)).resume(state)
    assert CheckpointManager(str(tmp_path)).resume(state, "cpu")[0] == 1


def test_mesh_train_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch, tmp_path):
    """The production mesh, the GNN and DLRM train steps over a mesh,
    ``build_cell(mesh=)`` and the elastic restore land on the card unless
    the caller asks for the CPU: without a card they raise before any
    process group exists."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.configs.base import RecSysShape
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh

    class CardMesh:            # a card mesh's face
        device_type = "cuda"
        mesh_dim_names = ("data", "model")
        shape = (1, 1)

    state = {"w": torch.ones(4)}
    CheckpointManager(str(tmp_path), save_every=1, async_save=False).maybe_save(1, state)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: make_production_mesh(shape=(1, 1)),
                 lambda: steps.build_gnn_train("nequip", registry.smoke_config("nequip"),
                                               GNN_SHAPES["molecule"], mesh=CardMesh()),
                 lambda: steps.build_recsys_train("dlrm-mlperf",
                                                  registry.smoke_config("dlrm-mlperf"),
                                                  RecSysShape("t", "train", 4), mesh=CardMesh()),
                 lambda: steps.build_cell("nequip", "molecule", mesh=CardMesh()),
                 lambda: CheckpointManager(str(tmp_path)).resume(state, mesh=CardMesh())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not torch.distributed.is_initialized()


def test_lm_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """The LM builders (prefill, decode, the paper pipeline with an LM as
    CE, ``build_cell``), ``init_cross_encoder`` of a model-zoo LM and
    ``convert.lm_params`` / ``lm_cache`` land on the card unless the caller
    asks for the CPU: without a card they raise before drawing anything."""
    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.configs.base import LMShape
    from repro_torch.launch import steps
    from repro_torch.models.cross_encoder import init_cross_encoder

    cfg = registry.smoke_config("granite-moe-1b-a400m")
    x = np.zeros((2, 1, 3, 1, 4), np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: steps.build_lm_prefill("g", cfg, LMShape("p", "prefill", 8, 1)),
                 lambda: steps.build_lm_decode("g", cfg, LMShape("d", "decode", 8, 1)),
                 lambda: steps.build_lm_adacur_serve("g", cfg, n_items=64, batch=1),
                 lambda: steps.build_cell("qwen3-8b", "decode_32k"),
                 lambda: init_cross_encoder(cfg, torch.Generator()),
                 lambda: convert.lm_params({"layers": {"w": x}}),
                 lambda: convert.lm_cache({"k": x, "v": x})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert convert.lm_cache({"k": x, "v": x}, device="cpu")["layers"][1]["k"].shape == (1, 3, 1, 4)


def test_recsys_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """BST, BERT4Rec and MIND (their inits, ``convert``'s carriers,
    BERT4Rec's negatives, the recsys builders and ``build_cell``) land on
    the card unless the caller asks for the CPU: without a card they raise
    before drawing anything."""
    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.launch import steps
    from repro_torch.models.recsys import bert4rec, bst, mind

    cfgs = {a: registry.smoke_config(a) for a in ("bst", "bert4rec", "mind")}
    x = {"w": np.zeros((2, 3), np.float32)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: bst.init_bst(cfgs["bst"], torch.Generator()),
             lambda: bert4rec.init_bert4rec(cfgs["bert4rec"], torch.Generator()),
             lambda: mind.init_mind(cfgs["mind"], torch.Generator()),
             lambda: bert4rec.negatives(2, cfgs["bert4rec"]),
             lambda: convert.bst_params(x), lambda: convert.bert4rec_params(x),
             lambda: convert.mind_params(x)]
    for arch, cfg in cfgs.items():
        calls += [lambda cfg=cfg: steps.recsys_init(cfg),
                  lambda cfg=cfg: steps.recsys_train_inputs(cfg, 2),
                  lambda arch=arch, cfg=cfg: steps.build_recsys_serve(
                      arch, cfg, RECSYS_SHAPES["serve_p99"]),
                  lambda arch=arch, cfg=cfg: steps.build_recsys_retrieval(
                      arch, cfg, RECSYS_SHAPES["retrieval_cand"]),
                  lambda arch=arch, cfg=cfg: steps.build_recsys_train(
                      arch, cfg, RECSYS_SHAPES["train_batch"]),
                  lambda arch=arch: steps.build_cell(arch, "serve_p99")]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert convert.mind_params(x, device="cpu")["w"].device == torch.device("cpu")


def test_gnn_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """NequIP's init, ``convert.nequip_params``, the GNN builders' inputs,
    graphs and train step and ``build_cell`` land on the card unless the
    caller asks for the CPU: without a card they raise before drawing
    anything."""
    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.launch import steps
    from repro_torch.models.gnn import nequip

    cfg = registry.smoke_config("nequip")
    mol, full = GNN_SHAPES["molecule"], GNN_SHAPES["full_graph_sm"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: nequip.init_nequip(cfg, torch.Generator()),
                 lambda: convert.nequip_params({"embed": np.zeros((2, 3), np.float32)}),
                 lambda: steps.gnn_init(cfg, mol), lambda: steps.gnn_inputs(cfg, mol),
                 lambda: steps.gnn_graph(full, 0),
                 lambda: steps.build_gnn_train("nequip", cfg, mol),
                 lambda: steps.build_cell("nequip", "molecule")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert nequip.init_nequip(cfg, torch.Generator(), device="cpu")["embed"].shape == (8, 4)


def test_convert_follows_the_device_rule():
    """``convert`` lands the JAX package's state on the card unless the
    caller asks for the CPU: without a card it raises the rule's error."""
    from repro_torch import convert

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: convert.r_anc lands on it")
    x = np.zeros((2, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.r_anc(x)
    assert convert.r_anc(x, device="cpu").device == torch.device("cpu")
    moments = {"bot": {"b0_w": x}, "top": {}, "tables": [x]}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.adamw_state(1, moments, moments)
    assert convert.adamw_state(1, moments, moments, device="cpu").step.dtype == torch.int32


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "CUDA_ROOTS", ())
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        build.build_all()
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        build.load("approx_topk")


def test_build_dir_is_keyed_by_the_sources(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_REPO", tmp_path)
    d = build.build_dir()
    assert d.parent == tmp_path / "build" / "kernels" and len(d.name) == 16
    assert {p.name for p in build._sources()[0]} == {"approx_topk.cu", "approx_topk_large.cu",
                                                     "persistent_round.cu",
                                                     "flash_attention.cu", "embedding_bag.cu",
                                                     "tensor_product.cu"}
