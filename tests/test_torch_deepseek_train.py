"""Port vs reference: training the deepseek family (``moe_lm``:
deepseek-v3-671b and deepseek-v2-236b) at reduced size on the CPU (3
layers: 1 dense + 2 MoE of 4 experts top-2 with 1 (v3) or 2 (v2) shared
experts; MLA with q/k heads of 16 nope + 8 rope and v heads of 16,
d_model 64), at the configs' capacity factor 1.25.

* Loss and every gradient of ``train_loss`` against
  ``jax.value_and_grad(repro.models.model.train_loss)`` in fp32 at s 64
  (picks dropped at capacity included), weights from the reference's
  ``init_model`` carried across by ``bridge.params_from_numpy``; and at s
  4096, where both packages' MLA layers take the flash branch of ``_sdpa``
  at q/k width 24 and v width 16 (spies on both sides prove it).
* The MLA layer alone and the MoE layer alone (with its shared experts,
  with and without picks dropped at capacity) against ``jax.grad`` of the
  reference's.
* The expert factors (layer, expert, m, k): the reference's leaf kinds
  for every leaf (router, MLA's dense projections and norms, the shared
  experts, the dense layer's spectral MLP, the embedding), the
  retraction slice by slice under both configs' methods.
* A 10-step fp32 trajectory through both packages' ``make_train_step``,
  one legacy bf16 step, resuming a reference-written checkpoint, the
  port's own save/resume bit for bit, and the train CLI.

Gradients are compared after dividing by the reference's RMS at rtol and
atol 1e-4, losses at 1e-5 relative, factors at 1e-4 absolute, as in
``tests/test_torch_jamba_train.py``. Moving the reference's weights by one
ulp moves its own gradients by up to ~8e-5 of their RMS (measured at s 64:
the MoE experts' and the embedding's leaves), about the fixed tolerance,
and the port sits up to ~1e-4 from it (v2's embedding). So the
model-level comparisons hold the port to the larger of the fixed
tolerance and SPREAD_FACTOR times that spread, measured in the test from
ULP_RUNS such moves; the layer-level ones to the fixed tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import Trainer as JTrainer  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.core.tree import max_orthogonality_error as jax_ortho  # noqa: E402
from repro.data.synthetic import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import make_sct_optimizer as jax_make_opt  # noqa: E402
from repro_torch.api import RunSpec, Trainer, log_metrics  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint.store import flatten  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core.retraction import retract  # noqa: E402
from repro_torch.core.tree import max_orthogonality_error, retract_tree, tree_map  # noqa: E402
from repro_torch.kernels.build import LAUNCHES  # noqa: E402
from repro_torch.kernels.testing import Tol, assert_scaled_close, kernel_error  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import make_sct_optimizer  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["deepseek-v3-671b", "deepseek-v2-236b"]
GRAD = Tol(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
FACTOR_ATOL = 1e-4
BF16_RTOL = 5e-2
ULP_RUNS = 2          # the reference's runs from weights one ulp away
SPREAD_FACTOR = 4


def _rel(a, b):
    return abs(float(a) / float(b) - 1.0)


def _cfgs(arch, **kw):
    return (jax_get_config(arch, reduced=True).replace(**kw),
            get_config(arch, reduced=True).replace(**kw))


def _params(jcfg, tcfg, seed=0):
    jp = jm.init_model(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.device_get(jp), tcfg, device="cpu")


def _batch(vocab, seq, step, batch):
    tokens, labels = JaxDataset(vocab=vocab, seq_len=seq, seed=0).batch(step, batch)
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": torch.tensor(tokens), "labels": torch.tensor(labels)})


def _ulp_moved(tree, seed):
    """``tree`` with every fp32 leaf moved one ulp up or down at random."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        to = np.where(rng.random(a.shape) < 0.5, np.float32(np.inf), np.float32(-np.inf))
        return jnp.asarray(np.nextafter(a, to.astype(np.float32)))
    return jax.tree.map(move, tree)


def _spread_tol(base, spread):
    """``base``, or SPREAD_FACTOR times how far the reference's own result
    moves when its weights move one ulp, where that is larger."""
    return max(base, SPREAD_FACTOR * spread)


def _check_grads(leaves, ref, moved):
    """Every leaf's gradient against the reference's, at 1e-4 of its RMS or
    SPREAD_FACTOR times the reference's spread over ``moved``."""
    assert sorted(ref) == sorted(leaves)
    for key, r in ref.items():
        g = leaves[key].grad
        assert g is not None and bool(torch.isfinite(g).all()), key
        spread = max(kernel_error(np.asarray(m[key]), r).max_scaled for m in moved)
        tol = _spread_tol(GRAD.atol, spread)
        assert_scaled_close(g.numpy(), r, Tol(tol, tol), err_msg=f"{key} (tolerance {tol:.2e})")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """fp32 at s 64 with remat on, as in the config, at capacity factor
    1.25: the loss, its aux part and every gradient, no kernel launched
    (the direct softmax branch; CPU tensors)."""
    s = 64
    jcfg, tcfg = _cfgs(arch, dtype="float32", max_seq=s)
    assert tcfg.capacity_factor == 1.25 and tcfg.remat and tcfg.attention == "mla"
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batch(jcfg.vocab, s, 0, 2)
    value_and_grad = jax.jit(jax.value_and_grad(jm.train_loss, has_aux=True), static_argnums=2)
    (loss_ref, aux_ref), grads_ref = value_and_grad(jp, jb, jcfg)
    ref = {key: np.asarray(r) for key, r in flatten(jax.device_get(grads_ref)).items()}
    moved = [flatten(jax.device_get(value_and_grad(_ulp_moved(jp, seed), jb, jcfg)[1]))
             for seed in range(ULP_RUNS)]
    leaves = {key: t.requires_grad_() for key, t in flatten(tp).items()}
    before = dict(LAUNCHES)
    loss, metrics = tm.train_loss(tp, tb, tcfg)
    loss.backward()
    assert dict(LAUNCHES) == before
    assert _rel(loss.detach(), loss_ref) < LOSS_RTOL
    assert _rel(metrics["aux_loss"].detach(), aux_ref["aux_loss"]) < LOSS_RTOL
    assert "moe_layers/moe/shared/up/U" in leaves and "dense_layers/mlp/up/U" in leaves
    _check_grads(leaves, ref, moved)


def test_loss_and_grads_at_flash_length_match_reference(monkeypatch):
    """deepseek-v3 in fp32 at s 4096, b 1: both packages' MLA layers take
    the flash branch (the reference's ``_flash`` and the port's flash
    wrappers, spied on) at q/k width 24 and v width 16; under remat the
    port runs the flash forward twice a layer and its backward once, the
    launch counts ``chip_smoke.py`` requires of the kernels on the card."""
    s = 4096
    jcfg, tcfg = _cfgs(ARCHS[0], dtype="float32", max_seq=s)
    assert (s > jattn.FLASH_THRESHOLD and s % min(jattn.FLASH_Q_CHUNK, s) == 0
            and s % min(jattn.FLASH_KV_CHUNK, s) == 0)
    calls = {"jax": 0, "port_fwd": 0, "port_bwd": 0}
    widths = set()

    def spy(mod, name, key):
        inner = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[key] += 1
            if key == "port_fwd":
                widths.add((a[0].shape[-1], a[2].shape[-1]))
            return inner(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    spy(jattn, "_flash", "jax")
    spy(tattn, "flash_attention_fwd", "port_fwd")
    spy(tattn, "flash_attention_bwd", "port_bwd")
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batch(jcfg.vocab, s, 0, 1)
    value_and_grad = jax.jit(jax.value_and_grad(jm.train_loss, has_aux=True), static_argnums=2)
    (loss_ref, _), grads_ref = value_and_grad(jp, jb, jcfg)
    ref = {key: np.asarray(r) for key, r in flatten(jax.device_get(grads_ref)).items()}
    moved = [flatten(jax.device_get(value_and_grad(_ulp_moved(jp, seed), jb, jcfg)[1]))
             for seed in range(ULP_RUNS)]
    leaves = {k: v.requires_grad_() for k, v in flatten(tp).items()}
    loss, _ = tm.train_loss(tp, tb, tcfg)
    loss.backward()
    assert calls["jax"] >= 1, "the reference did not take its flash branch"
    assert calls["port_fwd"] == 2 * tcfg.n_layers and calls["port_bwd"] == tcfg.n_layers
    assert widths == {(tcfg.qk_nope_dim + tcfg.qk_rope_dim, tcfg.v_head_dim)}
    assert _rel(loss.detach(), loss_ref) < LOSS_RTOL
    _check_grads(leaves, ref, moved)


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_layer_grads_match_reference(arch):
    """One MLA layer (q_lora, kv_lora, RoPE on the rope channels, the
    expanded form) under autograd against jax.grad of the reference's
    ``apply_mla`` in fp32 at s 64: the gradients of the input and of every
    leaf (wdq, q_norm, wuq, wdkv, kv_norm, wukv, wo), at 1e-4 of the
    reference's RMS."""
    jcfg, tcfg = _cfgs(arch, dtype="float32")
    jp = jattn.init_mla(jax.random.PRNGKey(5), jcfg)
    rng = np.random.default_rng(6)
    b, s = 2, 64
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))

    def jloss(p, xx):
        return jnp.sum(jattn.apply_mla(p, xx, jcfg, positions=jnp.asarray(pos)) * w)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = tree_map(lambda a: torch.tensor(np.asarray(a)).requires_grad_(), jax.device_get(jp))
    tx = torch.tensor(x, requires_grad=True)
    out = tattn.apply_mla(tp, tx, tcfg, positions=torch.tensor(pos).long())
    (out * torch.tensor(w)).sum().backward()
    assert_scaled_close(tx.grad.numpy(), np.asarray(ref[1]), GRAD, err_msg="dx")
    leaves = flatten(tp)
    assert sorted(leaves) == sorted(flatten(jax.device_get(ref[0])))
    for key, r in flatten(jax.device_get(ref[0])).items():
        assert_scaled_close(leaves[key].grad.numpy(), np.asarray(r), GRAD, err_msg=key)


@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_grads_match_reference(arch, cf):
    """The MoE layer with its shared experts under autograd against
    jax.grad of the reference's apply_moe in fp32: the gradients of the
    input and of every leaf (router, routed and shared spectral experts)
    through the router's softmax and top-k, the gates, the capacity-bounded
    dispatch (at 1.25 picks are dropped) and the aux loss, at 1e-4 of the
    reference's RMS."""
    from repro.nn import moe as jmoe
    from repro_torch.nn import moe as tmoe

    jcfg, tcfg = _cfgs(arch, dtype="float32")
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    assert "shared" in jp
    rng = np.random.default_rng(4)
    # tokens leaning toward expert 0, so that 1.25 drops picks
    w0 = np.asarray(jp["router"]["w"])[:, 0]
    x = (rng.standard_normal((2, 24, jcfg.d_model)) + 2.0 * w0 / np.linalg.norm(w0)
         ).astype(np.float32)
    w = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    T = x.shape[0] * x.shape[1]
    _, idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x.reshape(T, -1)) @ jp["router"]["w"]),
                           jcfg.top_k)
    counts = np.bincount(np.asarray(idx).ravel(), minlength=jcfg.n_experts)
    assert (counts > tmoe.capacity(jcfg, T, cf)).any() == (cf == 1.25)

    def jloss(p, xx):
        out, aux = jmoe.apply_moe(p, xx, jcfg, capacity_factor=cf)
        return jnp.sum(out * w) + 0.37 * aux

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = tree_map(lambda a: torch.tensor(np.asarray(a)).requires_grad_(), jax.device_get(jp))
    tx = torch.tensor(x, requires_grad=True)
    out, aux = tmoe.apply_moe(tp, tx, tcfg, capacity_factor=cf)
    (out * torch.tensor(w)).sum().add(0.37 * aux).backward()
    assert_scaled_close(tx.grad.numpy(), np.asarray(ref[1]), GRAD, err_msg="dx")
    leaves = flatten(tp)
    for key, r in flatten(jax.device_get(ref[0])).items():
        assert_scaled_close(leaves[key].grad.numpy(), np.asarray(r), GRAD, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_train_as_the_reference_does(arch):
    """Every leaf gets the reference's kind (U/V, s, dense: the
    per-component learning rates): the router, MLA's dense projections and
    norms, the shared experts, the dense layer's spectral MLP and the
    embedding among them. The stacked expert factors (layer, expert, m,
    k) retract slice by slice, under the reduced config's QR and the full
    config's CholeskyQR2."""
    jcfg, tcfg = _cfgs(arch, dtype="float32")
    jp, tp = _params(jcfg, tcfg)
    kinds = flatten(tadamw._leaf_kind_tree(tp))
    assert kinds == {key: int(v) for key, v in flatten(jadamw._leaf_kind_tree(jp)).items()}
    for key in ("moe_layers/moe/router/w", "moe_layers/attn/wukv/w", "moe_layers/attn/q_norm/scale",
                "moe_layers/moe/shared/up/U", "dense_layers/mlp/up/s", "embed/w"):
        assert key in kinds, key
    U = tp["moe_layers"]["moe"]["up"]["U"]
    assert U.dim() == 4 and kinds["moe_layers/moe/up/U"] == 1
    noisy = U + 1e-3 * torch.tensor(np.random.default_rng(0).standard_normal(U.shape),
                                    dtype=U.dtype)
    full = get_config(arch)
    assert full.sct.retraction == "cholesky_qr2" and full.n_experts >= 160
    for method in (tcfg.sct.retraction, full.sct.retraction):
        tree = retract_tree({"g": {"U": noisy, "s": torch.ones(U.shape[:-2] + U.shape[-1:]),
                                   "V": noisy}}, method)
        for layer in range(U.shape[0]):
            for e in range(U.shape[1]):
                assert torch.allclose(tree["g"]["U"][layer, e], retract(noisy[layer, e], method),
                                      atol=1e-6), method
        assert float(max_orthogonality_error(tree)) < FACTOR_ATOL, method


def _jax_trajectory(jcfg, jopt, jstep, jp, steps, seq, batch):
    jstate = jopt.init(jp)
    losses = []
    for i in range(steps):
        jstate, met = jstep(jstate, _batch(jcfg.vocab, seq, i, batch)[0])
        losses.append(float(met["loss"]))
    return losses, jstate


def _trajectory(arch, steps, seq=32, batch=2, ulp_runs=0, **opt_kw):
    """The port's and the reference's losses and final states over
    ``steps``, and the reference's again from ``ulp_runs`` one-ulp moves of
    its initial weights."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    kw = dict(lr=1e-3, warmup=3, total_steps=steps, **opt_kw)
    topt = make_sct_optimizer(tcfg, **kw)
    tstate, tstep = topt.init(tp), make_train_step(tcfg, topt)
    losses = []
    for i in range(steps):
        tstate, met = tstep(tstate, _batch(jcfg.vocab, seq, i, batch)[1])
        assert set(met) == {"loss", "ce_loss", "aux_loss"} and float(met["aux_loss"]) > 0
        losses.append(float(met["loss"]))
    jopt = jax_make_opt(jcfg, **kw)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt))      # compiled once for every run
    jlosses, jstate = _jax_trajectory(jcfg, jopt, jstep, jp, steps, seq, batch)
    moved = [_jax_trajectory(jcfg, jopt, jstep, _ulp_moved(jp, seed), steps, seq, batch)
             for seed in range(ulp_runs)]
    return list(zip(losses, jlosses)), tstate, jstate, moved


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_trajectory_matches_reference(arch):
    """Ten fp32 steps. Losses at 1e-5 relative and factors at 1e-4, or at
    SPREAD_FACTOR times the reference's own spread over one-ulp moves of
    its initial weights where that is larger."""
    losses, tstate, jstate, moved = _trajectory(arch, 10, ulp_runs=ULP_RUNS, precision="fp32")
    for i, (got, ref) in enumerate(losses):
        spread = max(_rel(m[0][i], ref) for m in moved)
        assert _rel(got, ref) < _spread_tol(LOSS_RTOL, spread), f"step {i + 1}: {got} vs {ref}"
    assert int(tstate["step"]) == 10
    ref = flatten(jax.device_get(jstate["params"]))
    moved = [flatten(jax.device_get(m[1]["params"])) for m in moved]
    for key, t in flatten(tstate["params"]).items():
        r = np.asarray(ref[key])
        spread = max(float(np.max(np.abs(np.asarray(m[key]) - r))) for m in moved)
        np.testing.assert_allclose(t.numpy(), r, rtol=0,
                                   atol=_spread_tol(FACTOR_ATOL, spread), err_msg=key)
    assert abs(float(max_orthogonality_error(tstate["params"]))
               - float(jax_ortho(jstate["params"]))) < FACTOR_ATOL
    assert float(max_orthogonality_error(tstate["params"])) < FACTOR_ATOL


def test_train_step_consumes_its_state():
    """``make_train_step``'s step updates the state it is given in place:
    the returned moments and every parameter but the retracted factors U
    and V are the given tensors, all of them moved by the step; a copy of
    the state taken before the step keeps the old values, and stepping it
    gives the same bits."""
    jcfg, tcfg = _cfgs(ARCHS[0])
    _, tp = _params(jcfg, tcfg)
    opt = make_sct_optimizer(tcfg, lr=1e-3, warmup=3, total_steps=2, precision="fp32")
    step, batch = make_train_step(tcfg, opt), _batch(jcfg.vocab, 32, 0, 2)[1]
    state = opt.init(tp)
    kept = tree_map(torch.clone, state)
    before = {k: t.clone() for k, t in flatten(state).items()}
    given = flatten(state)
    new, _ = step(state, batch)
    out = flatten(new)
    retracted = [k for k in out if k.split("/")[-1] in ("U", "V") and k.startswith("params/")]
    assert retracted
    for key, t in given.items():
        if key in ("step", "opt/count"):
            continue
        if key not in retracted:
            assert out[key] is t, key
        assert not torch.equal(t, before[key]), key
    for key, t in flatten(kept).items():
        assert torch.equal(t, before[key]), key
    again, _ = step(kept, batch)
    for key, t in flatten(again).items():
        assert torch.equal(t, out[key]), key


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_legacy_step_matches_reference(arch):
    losses, _, _, _ = _trajectory(arch, 1)     # reduced config: bf16 compute, legacy
    (got, ref), = losses
    assert np.isfinite(got) and _rel(got, ref) < BF16_RTOL


def _spec(arch, directory, steps=6, cls=RunSpec):
    return cls.from_dict({
        "model": {"arch": arch, "reduced": True},
        "train": {"steps": steps, "batch": 2, "seq": 32, "lr": 1e-3},
        "precision": {"mode": "fp32"},
        "checkpoint": {"directory": str(directory), "every": 3},
    })


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_from_reference_checkpoint(arch, tmp_path):
    """The reference's Trainer writes the moe_lm tree (npz: the dense and
    MoE stacks, the experts' stacked factors, AdamW's moments); the port
    resumes it and reproduces the next three losses."""
    jtrainer = JTrainer(_spec(arch, tmp_path / "jax", cls=JRunSpec))
    for _ in range(3):
        jtrainer.step()
    assert jtrainer.save() == 3
    jax_losses = [float(jtrainer.step()["loss"]) for _ in range(3)]
    trainer = Trainer.resume(str(tmp_path / "jax"), device="cpu")
    assert trainer.current_step == 3
    assert "moe_layers/moe/up/U" in flatten(trainer.params)
    losses = [float(trainer.step()["loss"]) for _ in range(3)]
    for i, (got, ref) in enumerate(zip(losses, jax_losses)):
        assert _rel(got, ref) < LOSS_RTOL, f"step {i + 4}: {got} vs {ref}"


def test_save_and_resume_are_bit_identical(tmp_path):
    arch = ARCHS[0]
    straight = Trainer(_spec(arch, tmp_path / "a"), device="cpu")
    losses = [float(straight.step()["loss"]) for _ in range(6)]
    first = Trainer(_spec(arch, tmp_path / "b"), device="cpu")
    head = [float(first.step()["loss"]) for _ in range(3)]
    first.save()
    resumed = Trainer.resume(str(tmp_path / "b"), device="cpu")
    tail = [float(resumed.step()["loss"]) for _ in range(3)]
    assert head + tail == losses
    final = Trainer.resume(str(tmp_path / "b"), device="cpu").fit()
    assert int(final["step"]) == 6
    for key, t in flatten(final["params"]).items():
        assert torch.equal(t, flatten(straight.params)[key]), key
    for key, t in flatten(final["opt"]).items():
        assert torch.equal(t, flatten(straight.state["opt"])[key]), key


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_deepseek_on_cpu_and_needs_a_device(arch, tmp_path, capsys,
                                                             monkeypatch):
    train_cli.main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
                    "--device", "cpu", "--ckpt-dir", str(tmp_path / "run")])
    assert "final ortho error" in capsys.readouterr().out
    log_metrics(3, {"loss": 2.5, "ce_loss": 2.25, "aux_loss": 0.125})
    assert capsys.readouterr().out.split() == ["step", "3", "loss", "2.5000", "ce", "2.2500",
                                               "aux", "0.1250"]
    assert sorted(p.name for p in (tmp_path / "run").glob("*.npz")) == ["step_00000002.npz"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", arch, "--reduced", "--steps", "1",
                        "--ckpt-dir", str(tmp_path / "gpu")])
