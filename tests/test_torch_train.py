"""Port vs reference: the training slice at reduced size on the CPU.

Weights come from the reference's ``init_model`` and cross over through
``bridge.params_from_numpy``; data from each package's copy of the
synthetic stream (the same batches from the same seed).

* The loss and gradients at s = 4096, where both packages take the flash
  branch of ``_sdpa`` (a spy on each side's ``_flash`` proves it), fp32.
* A 10-step fp32 trajectory through both packages' ``make_train_step``
  with the same optimizer settings: loss at every step within 1e-5
  relative; factors after step 10 and ``max_orthogonality_error`` within
  1e-4 absolute.
* One legacy-precision step at bf16 compute over fp32 masters: loss
  within the bf16 rung (5e-2 relative). The reference's default spectral
  path rounds h to bf16 where the port keeps it fp32, and scores are
  rounded at other places.
* Resuming from a checkpoint the reference's Trainer wrote reproduces its
  next three losses (1e-5 relative), the reference resumes the port's
  checkpoint, and the port's own save/resume is bit-identical.
* The train CLI runs on the CPU when asked and raises without a GPU
  otherwise; no module of the port imports JAX or the reference.
"""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import Trainer as JTrainer  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.core import retraction as jret  # noqa: E402
from repro.core.tree import max_orthogonality_error as jax_ortho  # noqa: E402
from repro.core.tree import spectral_leaf_mask as jax_leaf_mask  # noqa: E402
from repro.data.synthetic import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.optim import make_sct_optimizer as jax_make_opt  # noqa: E402
from repro_torch.api import RunSpec, Trainer  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint.store import flatten  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import retraction as tret  # noqa: E402
from repro_torch.core.tree import max_orthogonality_error, spectral_leaf_mask  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMDataset  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.optim import make_sct_optimizer  # noqa: E402

torch.set_num_threads(2)

ARCH = "smollm2-1.7b"
ROOT = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5
FACTOR_ATOL = 1e-4
BF16_RTOL = 5e-2


def _cfgs(**kw):
    return (jax_get_config(ARCH, reduced=True).replace(**kw),
            get_config(ARCH, reduced=True).replace(**kw))


def _params(jcfg, tcfg, seed=0):
    jp = jm.init_model(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.device_get(jp), tcfg, device="cpu")


def _batch(vocab, seq, step, batch):
    tokens, labels = JaxDataset(vocab=vocab, seq_len=seq, seed=0).batch(step, batch)
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": torch.tensor(tokens), "labels": torch.tensor(labels)})


def _rel(a, b):
    return abs(float(a) / float(b) - 1.0)


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) > 40 and not bad, bad


def test_synthetic_stream_matches_reference():
    ref = JaxDataset(vocab=512, seq_len=33, seed=7).batch(3, 4)
    got = SyntheticLMDataset(vocab=512, seq_len=33, seed=7).batch(3, 4)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_loss_and_grads_at_flash_length_match_reference(monkeypatch):
    s = 4096
    jcfg, tcfg = _cfgs(dtype="float32", max_seq=s)
    # the reference's condition (nn/attention.py:_sdpa) holds at this shape
    assert (s > jattn.FLASH_THRESHOLD and s % min(jattn.FLASH_Q_CHUNK, s) == 0
            and s % min(jattn.FLASH_KV_CHUNK, s) == 0)
    calls = {"jax": 0, "port_fwd": 0, "port_bwd": 0}

    def spy(mod, name, key):
        inner = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[key] += 1
            return inner(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    spy(jattn, "_flash", "jax")
    spy(tattn, "flash_attention_fwd", "port_fwd")
    spy(tattn, "flash_attention_bwd", "port_bwd")
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batch(jcfg.vocab, s, 0, 1)
    (loss_ref, _), grads_ref = jax.value_and_grad(jm.train_loss, has_aux=True)(jp, jb, jcfg)
    leaves = {k: v.requires_grad_() for k, v in flatten(tp).items()}
    loss, _ = tm.train_loss(tp, tb, tcfg)
    loss.backward()
    loss = loss.detach()
    assert calls["jax"] >= 1, "the reference did not take its flash branch"
    # remat: every layer's flash forward runs twice (forward and recompute),
    # its backward once — the launch counts chip_smoke.py requires on the card
    assert calls["port_fwd"] == 2 * tcfg.n_layers and calls["port_bwd"] == tcfg.n_layers
    assert _rel(loss, loss_ref) < LOSS_RTOL
    for key, ref in flatten(jax.device_get(grads_ref)).items():
        g, ref = leaves[key].grad.numpy(), np.asarray(ref)
        scale = max(float(np.sqrt(np.mean(ref ** 2))), 1e-12)
        np.testing.assert_allclose(g / scale, ref / scale, rtol=1e-4, atol=1e-4, err_msg=key)


def _trajectory(steps, seq=64, batch=4, **opt_kw):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    kw = dict(lr=1e-3, warmup=3, total_steps=steps, **opt_kw)
    jopt, topt = jax_make_opt(jcfg, **kw), make_sct_optimizer(tcfg, **kw)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jstep, tstep = jax.jit(jax_make_train_step(jcfg, jopt)), make_train_step(tcfg, topt)
    losses = []
    for i in range(steps):
        jb, tb = _batch(jcfg.vocab, seq, i, batch)
        jstate, jmet = jstep(jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        losses.append((float(tmet["loss"]), float(jmet["loss"])))
    return losses, tstate, jstate


def test_fp32_trajectory_matches_reference():
    losses, tstate, jstate = _trajectory(10, precision="fp32")
    for i, (got, ref) in enumerate(losses):
        assert _rel(got, ref) < LOSS_RTOL, f"step {i + 1}: {got} vs {ref}"
    assert int(tstate["step"]) == 10 and int(tstate["opt"]["count"]) == 10
    ref = flatten(jax.device_get(jstate["params"]))
    for key, t in flatten(tstate["params"]).items():
        np.testing.assert_allclose(t.numpy(), np.asarray(ref[key]), rtol=0,
                                   atol=FACTOR_ATOL, err_msg=key)
    assert abs(float(max_orthogonality_error(tstate["params"]))
               - float(jax_ortho(jstate["params"]))) < FACTOR_ATOL
    assert float(max_orthogonality_error(tstate["params"])) < FACTOR_ATOL


def test_bf16_legacy_step_matches_reference():
    losses, _, _ = _trajectory(1)              # reduced config: bf16 compute, legacy
    (got, ref), = losses
    assert np.isfinite(got) and _rel(got, ref) < BF16_RTOL


def test_tree_helpers_match_reference():
    """The spectral leaf mask and the orthogonality error of a model's
    tree, drifted off the manifold, equal the reference's."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(6)
    drift = {k: 1e-3 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in flatten(tp).items()}
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x + drift["/".join(p.key for p in path)], jp)
    tp = params_from_numpy(jax.device_get(jp), tcfg, device="cpu")
    assert spectral_leaf_mask(tp) == jax_leaf_mask(jax.device_get(jp))
    assert abs(float(max_orthogonality_error(tp)) - float(jax_ortho(jp))) < 1e-6


@pytest.mark.parametrize("method", ["qr", "cholesky_qr2", "cayley"])
def test_retractions_match_reference(method):
    rng = np.random.default_rng(2)
    U = np.linalg.qr(rng.standard_normal((3, 96, 12)))[0] + 1e-2 * rng.standard_normal(
        (3, 96, 12))
    U = U.astype(np.float32)
    got = tret.retract(torch.tensor(U), method)
    ref = jret.retract(jnp.asarray(U), method)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    assert got.dtype == torch.float32
    assert tret.qr_retract(torch.tensor(U).bfloat16()).dtype == torch.bfloat16


def _spec(directory, steps=6, cls=RunSpec):
    return cls.from_dict({
        "model": {"arch": ARCH, "reduced": True},
        "train": {"steps": steps, "batch": 2, "seq": 32, "lr": 1e-3},
        "precision": {"mode": "fp32"},
        "checkpoint": {"directory": str(directory), "every": 3},
    })


def test_resume_from_reference_checkpoint(tmp_path):
    jtrainer = JTrainer(_spec(tmp_path / "jax", cls=JRunSpec))
    for _ in range(3):
        jtrainer.step()
    assert jtrainer.save() == 3
    jax_losses = [float(jtrainer.step()["loss"]) for _ in range(3)]

    trainer = Trainer.resume(str(tmp_path / "jax"), device="cpu")
    assert trainer.current_step == 3 and trainer.spec.train.steps == 6
    losses = [float(trainer.step()["loss"]) for _ in range(3)]
    for i, (got, ref) in enumerate(zip(losses, jax_losses)):
        assert _rel(got, ref) < LOSS_RTOL, f"step {i + 4}: {got} vs {ref}"

    # and the other way: the reference resumes the port's checkpoint
    port = Trainer(_spec(tmp_path / "port"), device="cpu")
    for _ in range(3):
        port.step()
    port.save()
    port_loss = float(port.step()["loss"])
    back = JTrainer.resume(str(tmp_path / "port"))
    assert back.current_step == 3
    assert _rel(float(back.step()["loss"]), port_loss) < LOSS_RTOL


def test_save_and_resume_are_bit_identical(tmp_path):
    straight = Trainer(_spec(tmp_path / "a"), device="cpu")
    losses = [float(straight.step()["loss"]) for _ in range(6)]

    first = Trainer(_spec(tmp_path / "b"), device="cpu")
    head = [float(first.step()["loss"]) for _ in range(3)]
    first.save()
    resumed = Trainer.resume(str(tmp_path / "b"), device="cpu")
    tail = [float(resumed.step()["loss"]) for _ in range(3)]
    assert head + tail == losses

    # fit() picks the run up from the same checkpoint and ends where the
    # uninterrupted run ends
    final = Trainer.resume(str(tmp_path / "b"), device="cpu").fit()
    assert int(final["step"]) == 6
    for key, t in flatten(final["params"]).items():
        assert torch.equal(t, flatten(straight.params)[key]), key


def test_spec_json_is_the_reference_format(tmp_path):
    spec = _spec(tmp_path)
    assert JRunSpec.from_json(spec.to_json()).to_dict()["train"] == spec.to_dict()["train"]
    back = RunSpec.from_json(_spec(tmp_path, cls=JRunSpec).to_json())
    assert back == spec and RunSpec.from_json(back.to_json()) == back


@pytest.mark.parametrize("what", ["bf16", "mixed", "microbatches", "telemetry", "rank"])
def test_unported_training_options_raise(what, tmp_path):
    """bf16, mixed and microbatches are ported: the Trainer builds and
    takes a finite step in the asked mode; telemetry and a rank schedule
    still raise."""
    data = _spec(tmp_path).to_dict()
    if what in ("bf16", "mixed"):
        data["precision"]["mode"] = what
    elif what == "rank":
        data["rank"] = {"schedule": "static:8"}
    else:
        data["train"][what] = 2 if what == "microbatches" else True
    if what in ("telemetry", "rank"):
        with pytest.raises(NotImplementedError):
            Trainer(RunSpec.from_dict(data), device="cpu")
        return
    trainer = Trainer(RunSpec.from_dict(data), device="cpu")
    metrics = trainer.step()
    assert np.isfinite(float(metrics["loss"])) and trainer.current_step == 1
    dtypes = {t.dtype for t in flatten(trainer.params).values()}
    assert dtypes == {torch.bfloat16 if what == "bf16" else torch.float32}
    assert ("loss_scale" in metrics) == (what == "mixed")


def test_train_cli_runs_on_cpu(tmp_path, capsys):
    train_cli.main(["--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
                    "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final ortho error" in out
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == ["step_00000002.npz"]


def test_train_cli_needs_a_gpu_or_a_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])
