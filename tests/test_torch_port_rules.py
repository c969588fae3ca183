"""Rules the port keeps: it imports neither ``jax`` nor ``repro``, its entry
points run on the card unless told otherwise, it passes the repo's lint,
and its configuration matches the reference's field for field."""
import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis.lint import lint_root  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch import cuda_build, resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import period_spec  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    roots = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.append(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    bad = [r for r in _imported_roots(path) if r in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_scan_finds_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.models import x\n"
                 "from repro_torch import y\nfrom . import z\n")
    assert [r for r in _imported_roots(f) if r in FORBIDDEN] == [
        "jax", "repro"]


def test_entry_points_default_to_cuda():
    cfg = get_config("transformer-100m").smoke_config()
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
    api = build_model(cfg, device="cpu")
    assert api.device == torch.device("cpu")
    params = api.init(0)
    assert all(p.device.type == "cpu" for p in params.parameters())


def test_lint_finds_nothing_in_the_port():
    port = [f for f in lint_root(ROOT)
            if "repro_torch" in f.where or "chip_smoke" in f.where]
    assert port == [], port


DENSE = ["transformer-100m", "gemma2-27b", "yi-34b", "granite-20b",
         "mistral-large-123b"]


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference_field_for_field(smoke, name):
    port, ref = get_config(name), jax_get_config(name)
    if smoke:
        port, ref = port.smoke_config(), ref.smoke_config()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.head_dim_, port.padded_vocab, port.q_per_kv) == (
        ref.head_dim_, ref.padded_vocab, ref.q_per_kv)


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("smoke", [False, True])
def test_every_registry_config_passes_both_attention_kernels_shape_rules(
        smoke, name):
    """Each attention config, at its own heads, kv heads and head width in
    its own dtype, is taken by the decode kernel (serving, from pools in
    the parameters' dtype) and by the flash kernel (``use_pallas``, in the
    compute dtype, at a ragged length): a limit like a cap on the query
    heads per kv head cannot hide behind a cut-down smoke config."""
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.models.layers import dtype_of
    cfg = get_config(name)
    if smoke:
        cfg = cfg.smoke_config()
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    pools = dtype_of(cfg.param_dtype)
    decode_attention.check_shapes((8, H, hd), (65, 16, KV, hd), pools)
    size = torch.tensor([], dtype=pools).element_size()
    tiles, _, _ = decode_attention.launch_plan(8, H, KV, hd, size, 16, 512,
                                               132)
    assert tiles == 1, f"{name}: {H // KV} heads a kv head in {tiles} tiles"
    act = dtype_of(cfg.compute_dtype)
    for S in (100, 4096):
        flash_attention.check_shapes((1, H, S, hd), (1, KV, S, hd),
                                     (1, KV, S, hd), act)


def test_unported_architectures_raise_naming_their_slice():
    # the dense family resolves (gemma2 since the flash-attention route)
    assert get_config("gemma2-27b").name == "gemma2-27b"
    assert period_spec(get_config("gemma2-27b")) == (
        ("attn_local", "dense"), ("attn", "dense"))
    with pytest.raises(NotImplementedError, match="slice 5"):
        get_config("granite-moe-3b-a800m")
    moe = dataclasses.replace(get_config("transformer-100m"), family="moe",
                              n_experts=4, experts_per_tok=2)
    with pytest.raises(NotImplementedError, match="slice 5"):
        period_spec(moe)
    assert period_spec(get_config("transformer-100m")) == (("attn", "dense"),)


def test_build_helper_keys_libraries_by_source(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("extern \"C\" int f() { return 0; }\n")
    a = cuda_build.library_path(src)
    assert a.parent == cuda_build.BUILD_DIR and a.name.startswith("k-")
    assert cuda_build.library_path(src) == a
    src.write_text("extern \"C\" int f() { return 1; }\n")
    assert cuda_build.library_path(src) != a


def test_build_helper_raises_without_nvcc(monkeypatch):
    import shutil

    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.nvcc_path()


# ---------------------------------------------------------------------------
# slice 2: the trainer
# ---------------------------------------------------------------------------

def _fc_trainer(**kw):
    from repro_torch.core import AlgoConfig, MultiLearnerTrainer
    from repro_torch.models import fcnet
    from repro_torch.optim import sgd
    algo = kw.pop("algo", "dpsgd")
    return MultiLearnerTrainer(fcnet.loss_fn, sgd(0.1),
                               AlgoConfig(algo=algo, n_learners=4), **kw)


def test_trainer_entry_points_default_to_cuda():
    from repro_torch import quickstart
    from repro_torch.data import ShardedLoader, TemplateImages
    if torch.cuda.is_available():
        assert _fc_trainer().device.type == "cuda"
        assert ShardedLoader(TemplateImages(), 2, 4).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _fc_trainer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedLoader(TemplateImages(), n_learners=2, local_batch=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.train("dpsgd", steps=1)
    assert _fc_trainer(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("kw,slice_", [
    (dict(engine="pytree"), "slice 2"),
    (dict(algo="ssgd_star"), "slice 2"),
], ids=["pytree", "ssgd_star"])
def test_unported_trainer_paths_raise_naming_their_slice(kw, slice_):
    with pytest.raises(NotImplementedError, match=slice_):
        _fc_trainer(device="cpu", **kw)


def test_unported_trainer_methods_raise_naming_their_slice():
    from repro_torch.bench.common import train_fc
    from repro_torch.models import fcnet
    tr = _fc_trainer(device="cpu")
    state = tr.init(0, fcnet.init_params(torch.Generator().manual_seed(0)))
    with pytest.raises(NotImplementedError, match="slice 6"):
        tr.train_step(state._replace(members=object()), {})
    with pytest.raises(NotImplementedError, match="slice 6"):
        train_fc("dpsgd", 0.1, steps=2, fault_plan=object(), device="cpu")


def test_probe_hooks_fire_on_the_steps_their_schedule_makes_due():
    from repro_torch.core import AlgoConfig, MultiLearnerTrainer
    from repro_torch.data import ShardedLoader, TemplateImages
    from repro_torch.landscape import ProbeSchedule
    from repro_torch.models import fcnet
    from repro_torch.optim import controller_scale, scale_by_controller, sgd
    tr = MultiLearnerTrainer(fcnet.loss_fn, scale_by_controller(sgd(0.1)),
                             AlgoConfig(algo="dpsgd", n_learners=2),
                             device="cpu")
    state = tr.init(0, fcnet.init_params(torch.Generator().manual_seed(0)))
    loader = ShardedLoader(TemplateImages(), n_learners=2, local_batch=4,
                           device="cpu")
    seen = []

    def probe(view, batch):
        # a probe sees the tree view of the live state
        assert view.params["w1"].shape == (2, 784, 50)
        return view.step

    def halve(st, step):
        seen.append(step)
        return st._replace(opt_state={**st.opt_state, "scale":
                                      st.opt_state["scale"] * 0.5})

    sched = ProbeSchedule(every=3, start=1)
    tr.add_probe("p", sched, probe, on_result=halve)
    tr.add_probe("off", ProbeSchedule(every=0), lambda v, b: 1 / 0)
    due = []
    for i in range(8):
        if tr.probes_due(i):
            due.append(i)
            state, results = tr.run_probes(state, loader.batch(i), step=i)
            assert results == {"p": i}
        state, _ = tr.train_step(state, loader.batch(i))
    assert due == seen == [i for i in range(8) if sched.due(i)] == [1, 4, 7]
    # on_result wrote the live optimizer state
    assert torch.equal(controller_scale(state.opt_state),
                       torch.full((2,), 0.125))


def test_trainer_rejects_unknown_backends():
    with pytest.raises(ValueError, match="kernel_backend"):
        _fc_trainer(device="cpu", kernel_backend="pallas")
    with pytest.raises(ValueError, match="engine"):
        _fc_trainer(device="cpu", engine="fast")
