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
    # the ssm, vlm and audio families the same way
    for name in ("xlstm-350m", "qwen2-vl-7b", "seamless-m4t-large-v2"):
        small = get_config(name).smoke_config()
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build_model(small)
        api = build_model(small, device="cpu")
        assert all(p.device.type == "cpu"
                   for p in api.init(0).parameters())


def test_lint_finds_nothing_in_the_port():
    port = [f for f in lint_root(ROOT)
            if "repro_torch" in f.where or "chip_smoke" in f.where]
    assert port == [], port


from repro_torch.configs import REGISTRY  # noqa: E402

# every config in the port's registry: the dense family, the moe
# (granite-moe, qwen3-moe) and hybrid (jamba) families since slice 5a, the
# ssm (xlstm), vlm (qwen2-vl) and audio (seamless) families since slice 5b
DENSE = sorted(REGISTRY)
# the configs with an attention layer (xlstm-350m has none)
ATTENTION = [n for n in DENSE
             if any(m.startswith("attn") for m, _ in period_spec(
                 get_config(n)))]


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference_field_for_field(smoke, name):
    port, ref = get_config(name), jax_get_config(name)
    if smoke:
        port, ref = port.smoke_config(), ref.smoke_config()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.head_dim_, port.padded_vocab, port.q_per_kv) == (
        ref.head_dim_, ref.padded_vocab, ref.q_per_kv)


@pytest.mark.parametrize("name", ATTENTION)
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
    """Slice 5b ported the last three families, so no architecture is
    refused any more: every name in the reference's registry resolves to
    the port's config with the reference's period spec, and an unknown
    name raises as in the reference.  What stays refused is what the
    reference cannot run either: ``use_pallas`` on the vlm and audio
    families (``ValueError``; on xlstm, which has no attention, it changes
    nothing), and serving a family without paged decode."""
    from repro.configs import REGISTRY as JAX_REGISTRY
    from repro.models import transformer as jt
    from repro_torch.serve import ServeEngine
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY)
    for name in JAX_REGISTRY:
        assert get_config(name).name == name
        for port, ref in ((get_config(name), jax_get_config(name)),
                          (get_config(name).smoke_config(),
                           jax_get_config(name).smoke_config())):
            assert period_spec(port) == jt.period_spec(ref), name
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    for name in ("qwen2-vl-7b", "seamless-m4t-large-v2"):
        cfg = dataclasses.replace(get_config(name).smoke_config(),
                                  use_pallas=True)
        with pytest.raises(ValueError, match="use_pallas"):
            build_model(cfg, device="cpu")
        api = build_model(get_config(name).smoke_config(), device="cpu")
        assert not api.has_paged and api.paged_decode_step is None
        with pytest.raises(ValueError, match="no paged decode"):
            ServeEngine(api, api.init(0))
    cfg = get_config("xlstm-350m").smoke_config()
    tokens = {"tokens": torch.randint(0, cfg.vocab, (1, 16))}
    outs = []
    for use_pallas in (False, True):
        api = build_model(dataclasses.replace(cfg, use_pallas=use_pallas),
                          device="cpu")
        assert api.has_paged
        with torch.no_grad():
            outs.append(api.apply(api.init(0), tokens))
    assert torch.equal(outs[0], outs[1])


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


@pytest.mark.parametrize("kw,raises", [
    (dict(engine="pytree"), None),
    (dict(algo="ssgd_star"), None),
    (dict(algo="ssgd_star", engine="flat"), "engine='pytree'"),
], ids=["pytree", "ssgd_star", "ssgd_star-flat"])
def test_unported_trainer_paths_raise_naming_their_slice(kw, raises):
    """The pytree engine and SSGD* were the rest of slice 2 and raised
    until they were ported: now both train, and the one combination the
    reference refuses (SSGD*'s per-leaf noise on the flat engine) raises
    ``ValueError`` naming the engine to use."""
    from repro_torch.data import ShardedLoader, TemplateImages
    from repro_torch.models import fcnet
    if raises is not None:
        with pytest.raises(ValueError, match=raises):
            _fc_trainer(device="cpu", **kw)
        return
    tr = _fc_trainer(device="cpu", **kw)
    assert not tr.is_flat
    state = tr.init(0, fcnet.init_params(torch.Generator().manual_seed(0)))
    loader = ShardedLoader(TemplateImages(), n_learners=4, local_batch=8,
                           device="cpu")
    state, m = tr.train_step(state, loader.batch(0))
    assert bool(torch.isfinite(m.loss)) and state.step == 1
    assert isinstance(state.params, dict)


def test_unported_trainer_methods_raise_naming_their_slice():
    """Elastic membership (slice 6) raised until it was ported: now a
    state with ``members`` trains and ``train_fc(fault_plan=...)`` runs
    under a supervisor, and no port module raises ``NotImplementedError``
    naming slice 6."""
    from repro_torch.bench.common import train_fc
    from repro_torch.core import FaultPlan, Membership
    from repro_torch.data import ShardedLoader, TemplateImages
    from repro_torch.models import fcnet
    tr = _fc_trainer(device="cpu")
    state = tr.init(0, fcnet.init_params(torch.Generator().manual_seed(0)))
    mem = Membership(4)
    mem.crash(2)
    state = tr.set_membership(state, mem)
    loader = ShardedLoader(TemplateImages(), n_learners=4, local_batch=8,
                           device="cpu")
    state, m = tr.train_step(state, loader.batch(0))
    assert bool(torch.isfinite(m.loss)) and float(m.n_active) == 3
    out = train_fc("dpsgd", 0.1, n=4, local_batch=8, steps=3,
                   fault_plan=FaultPlan.crash_rejoin(1, 0, 2), device="cpu")
    assert out["supervisor"].report.rejoins == [(2, 1)]
    assert all(torch.isfinite(torch.tensor(out["losses"])))
    for path in PORT_FILES:
        text = path.read_text()
        assert not ("NotImplementedError" in text and "slice 6" in text), \
            path


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
