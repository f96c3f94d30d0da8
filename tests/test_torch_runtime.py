"""Port vs reference: microbatching, the fault-tolerant loop, async
checkpoints, manifold and conversion utilities and the train CLI's new
flags, at reduced size on the CPU.

* Microbatching: fp32 with 4 microbatches against the reference's
  4-microbatch trajectory (losses at 1e-5 relative, parameters at 1e-4,
  or 4x the reference's own spread over one-ulp moves of its weights) and
  against the port's own single batch (2e-3, the reference's bound in
  ``tests/test_training_integration.py``); hybrid and moe_lm with 2
  microbatches against the reference's 2 (their MoE sizes capacity per
  forward, so never against the full batch): losses, and each leaf's
  change over the run against the reference's change.
* The async save: the host snapshot is taken before ``save`` returns, so
  parameters changed in place at once do not reach the file.
* The loop: a restart after an injected failure is bit-identical to an
  uninterrupted run (under ``mixed`` too, the loss scale with it), a
  restart across loop instances as well, too many failures raise, the
  restart flushes the save in flight before it restores and swallows the
  writer's error, a tiny deadline counts every step as a straggler.
* ``core/manifold.py`` and ``core/convert.py`` against the reference's.
* The train CLI with ``--precision mixed --microbatches 2``; its
  ``--dump-spec`` equals the reference CLI's spec for the same flags.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.core import convert as jconv  # noqa: E402
from repro.core import manifold as jman  # noqa: E402
from repro.data.synthetic import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.launch import train as jax_train_cli  # noqa: E402
from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.optim import make_sct_optimizer as jax_make_opt  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.store import flatten, load_pytree, to_tensor  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import convert as tconv  # noqa: E402
from repro_torch.core import manifold as tman  # noqa: E402
from repro_torch.core.precision import PrecisionPolicy  # noqa: E402
from repro_torch.core.tree import orthogonality_error, tree_map  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMDataset  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.model import init_model  # noqa: E402
from repro_torch.optim import make_sct_optimizer  # noqa: E402
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig  # noqa: E402

torch.set_num_threads(2)

ARCH = "smollm2-1.7b"
LOSS_RTOL = 1e-5
FACTOR_ATOL = 1e-4
CHANGE_RTOL = 1e-4          # a leaf's change, against the reference's change's RMS
ULP_RUNS = 2                # the reference's runs from weights one ulp away
SPREAD_FACTOR = 4
MICRO_FULL_TOL = 2e-3       # tests/test_training_integration.py:61


def _rel(a, b):
    return abs(float(a) / float(b) - 1.0)


def _batch(vocab, seq, step, batch):
    tokens, labels = JaxDataset(vocab=vocab, seq_len=seq, seed=0).batch(step, batch)
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": torch.tensor(tokens), "labels": torch.tensor(labels)})


# --------------------------------------------------------- microbatching --

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


def _rms(x):
    return float(np.sqrt(np.mean(np.square(x))))


def _change_error(got, ref, init):
    """How far a leaf's change from ``init`` is from the reference's: the
    RMS of the difference over the RMS of the reference's change (0 when
    neither moved, inf when only ``got`` did). A step that leaves the
    parameters as they were scores 1."""
    d_got, d_ref = got - init, ref - init
    num, den = _rms(d_got - d_ref), _rms(d_ref)
    return num / den if den > 0.0 else (0.0 if num == 0.0 else float("inf"))


def _micro_trajectories(arch, steps, microbatches, lr, seq=32, batch=8, port_full=False,
                        ulp_runs=ULP_RUNS):
    """The port's and the reference's losses and final parameters over
    ``steps`` fp32 steps with ``microbatches``, from the same weights (with
    ``port_full`` also the port's single batch), the initial parameters,
    and the reference's losses and parameters again from ``ulp_runs``
    one-ulp moves of its initial weights."""
    jcfg = jax_get_config(arch, reduced=True).replace(dtype="float32")
    tcfg = get_config(arch, reduced=True).replace(dtype="float32")
    jp = jm.init_model(jax.random.PRNGKey(0), jcfg)
    kw = dict(lr=lr, warmup=4, total_steps=steps, precision="fp32")
    runs = {}
    for mb in ((microbatches, 1) if port_full else (microbatches,)):
        topt = make_sct_optimizer(tcfg, **kw)
        tstate = topt.init(params_from_numpy(jax.device_get(jp), tcfg, device="cpu"))
        tstep = make_train_step(tcfg, topt, microbatches=mb)
        losses = []
        for i in range(steps):
            tstate, met = tstep(tstate, _batch(tcfg.vocab, seq, i, batch)[1])
            losses.append(float(met["loss"]))
        runs[mb] = (losses, {k: t.numpy() for k, t in flatten(tstate["params"]).items()})
    jopt = jax_make_opt(jcfg, **kw)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, microbatches=microbatches))

    def reference(params):
        jstate, losses = jopt.init(params), []
        for i in range(steps):
            jstate, met = jstep(jstate, _batch(jcfg.vocab, seq, i, batch)[0])
            losses.append(float(met["loss"]))
        return losses, {k: np.asarray(v) for k, v in
                        flatten(jax.device_get(jstate["params"])).items()}

    init = {k: np.asarray(v) for k, v in flatten(jax.device_get(jp)).items()}
    moved = [reference(_ulp_moved(jp, seed)) for seed in range(ulp_runs)]
    return runs, reference(jp), moved, init


def test_microbatching_matches_reference_and_full_batch():
    """fp32, 4 microbatches of 2 rows, 6 steps at the reference's rate
    (``tests/test_training_integration.py``: lr 3e-3): every loss at 1e-5
    of the reference's 4-microbatch step and the parameters at 1e-4 after
    step 6, or at SPREAD_FACTOR times the reference's own spread over
    one-ulp moves of its initial weights where that is larger (at this
    rate ``attn/wo`` sits ~1.3e-4 from the reference, about twice that
    spread); against the port's full batch every loss within 2e-3."""
    runs, (jlosses, ref), moved, _ = _micro_trajectories(ARCH, 6, 4, 3e-3, port_full=True)
    (micro, params), (full, _) = runs[4], runs[1]
    for i, (got, r) in enumerate(zip(micro, jlosses)):
        spread = max(_rel(m[0][i], r) for m in moved)
        assert _rel(got, r) < _spread_tol(LOSS_RTOL, spread), f"step {i + 1}: {got} vs {r}"
    for key, t in params.items():
        spread = max(float(np.max(np.abs(m[1][key] - ref[key]))) for m in moved)
        np.testing.assert_allclose(t, ref[key], rtol=0, atol=_spread_tol(FACTOR_ATOL, spread),
                                   err_msg=key)
    np.testing.assert_allclose(full, micro, rtol=MICRO_FULL_TOL, atol=MICRO_FULL_TOL)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "deepseek-v3-671b"])
def test_microbatched_moe_families_match_reference(arch):
    """hybrid and moe_lm, fp32, 2 microbatches of 2 rows, 3 steps at the
    config's capacity factor (the first at the warm-up's zero rate, so
    steps 2 and 3 update): losses (and the MoE's aux loss in them) at 1e-4
    relative of the reference's 2-microbatch step, which sizes the
    experts' capacity per microbatch as the port does; and every leaf's
    change over the run within CHANGE_RTOL of the reference's change (its
    RMS the unit), or SPREAD_FACTOR times the reference's own spread over
    one-ulp moves of its initial weights where that is larger."""
    runs, (jlosses, ref), moved, init = _micro_trajectories(arch, 3, 2, 1e-3, batch=4)
    losses, params = runs[2]
    for i, (got, r) in enumerate(zip(losses, jlosses)):
        assert _rel(got, r) < 1e-4, f"{arch} step {i + 1}: {got} vs {r}"
    for key, t in params.items():
        spread = max(_change_error(m[1][key], ref[key], init[key]) for m in moved)
        err = _change_error(t, ref[key], init[key])
        assert err <= _spread_tol(CHANGE_RTOL, spread), f"{arch} {key}: {err} (spread {spread})"


def test_microbatches_split_the_batch_into_equal_slices():
    tcfg = get_config(ARCH, reduced=True)
    opt = make_sct_optimizer(tcfg, precision="fp32")
    step = make_train_step(tcfg, opt, microbatches=3)
    state = opt.init(init_model(tcfg, seed=0, device="cpu"))
    with pytest.raises(ValueError, match="equal microbatches"):
        step(state, _batch(tcfg.vocab, 16, 0, 4)[1])
    with pytest.raises(ValueError):
        make_train_step(tcfg, opt, microbatches=0)


# ------------------------------------------------------------ async save --

def test_async_save_snapshots_before_returning(tmp_path):
    """``save`` (async) returns before the file is written, yet the file
    holds the state as it was when ``save`` was called: the tensors are
    changed in place at once (as the next training step does), then
    ``wait``. A writer's error is raised by ``wait``."""
    rng = np.random.default_rng(0)
    state = {"params": {"w": torch.tensor(rng.standard_normal((64, 32)).astype(np.float32)),
                        "b": torch.tensor(rng.standard_normal(32).astype(np.float32)).bfloat16()},
             "step": torch.tensor(7, dtype=torch.int32)}
    before = tree_map(lambda t: t.clone(), state)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(7, state)
    for t in (state["params"]["w"], state["params"]["b"]):
        t.add_(1.0)
    state["step"].add_(1)
    mgr.wait()
    step, saved = mgr.restore_latest()
    assert step == 7
    for key, t in flatten(before).items():
        got = to_tensor(flatten(saved)[key])
        assert got.dtype == t.dtype and torch.equal(got, t), key
    with open(tmp_path / "step_00000007.npz.meta.json") as f:
        assert json.load(f)["step"] == 7

    mgr.save(8, state)
    mgr.save(9, state)                       # one save in flight: 8 is written first
    mgr.wait()
    mgr.save(10, state, block=True)
    assert mgr.list_steps() == [9, 10]

    mgr.directory = str(tmp_path / "missing" / "dir")
    (tmp_path / "missing").write_text("a file where the directory should be")
    mgr.save(11, state)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                               # the error is raised once


# -------------------------------------------------------------- the loop --

def _make_loop(d, total=12, ckpt_every=4, failure_hook=None, deadline=None, precision=None,
               max_restarts=3):
    cfg = get_config(ARCH, reduced=True)
    opt = make_sct_optimizer(cfg, lr=1e-3, warmup=2, total_steps=total, precision=precision)
    step_fn = make_train_step(cfg, opt)
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=16, seed=0)

    def batches(start):
        step = start
        while True:
            t, l = ds.batch(step, 4)
            yield {"tokens": torch.as_tensor(t), "labels": torch.as_tensor(l)}
            step += 1

    return TrainLoop(
        step_fn=step_fn, batch_iter_factory=batches, ckpt_dir=str(d),
        cfg=TrainLoopConfig(total_steps=total, checkpoint_every=ckpt_every,
                            step_deadline_s=deadline, max_restarts=max_restarts),
        init_state_fn=lambda: opt.init(init_model(cfg, seed=0, device="cpu")),
        place_state_fn=lambda tree: tree_map(to_tensor, tree),
        failure_hook=failure_hook,
    )


def _bomb_at(step_no, events=None):
    crashed = {"done": False}

    def bomb(step):
        if step == step_no and not crashed["done"]:
            crashed["done"] = True
            if events is not None:
                events.append("crash")
            raise RuntimeError("injected node failure")
    return bomb, crashed


def _assert_states_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert set(fa) == set(fb)
    for key, t in fa.items():
        assert t.dtype == fb[key].dtype and torch.equal(t, fb[key]), key


@pytest.mark.parametrize("precision", [None, "mixed"])
def test_restart_is_bit_identical(tmp_path, precision):
    """12 steps straight against a run whose failure_hook raises at step
    8: one restart from the step-8 checkpoint, and the full final state
    (parameters, moments, step, loss scale) equal bit for bit. Under a
    mixed policy whose scale grows every 3 steps, the scale has grown."""
    pol = None if precision is None else PrecisionPolicy(
        name="mixed-fastgrow", compute_dtype="bfloat16", loss_scaling=True,
        init_scale=2.0 ** 10, growth_interval=3)
    straight_loop = _make_loop(tmp_path / "a", precision=pol)
    straight = straight_loop.run()
    bomb, _ = _bomb_at(8)
    loop = _make_loop(tmp_path / "b", failure_hook=bomb, precision=pol)
    resumed = loop.run()
    assert loop.restarts == 1 and straight_loop.restarts == 0
    assert int(resumed["step"]) == 12
    _assert_states_equal(straight, resumed)
    if pol is not None:
        assert float(resumed["loss_scale"]["scale"]) > 2.0 ** 10
        assert (np.asarray(resumed["loss_scale"]["scale"]).tobytes()
                == np.asarray(straight["loss_scale"]["scale"]).tobytes())
        assert loop.overflow_steps == 0


def test_restart_across_loop_instances(tmp_path):
    """The first loop dies at step 9 with no restart budget; a fresh loop
    on the same directory resumes from step 8 and ends on the
    uninterrupted run's parameters."""
    straight = _make_loop(tmp_path / "a").run()

    def bomb(step):
        if step == 9:
            raise RuntimeError("injected node failure")

    with pytest.raises(RuntimeError):
        _make_loop(tmp_path / "b", failure_hook=bomb, max_restarts=0).run()
    resumed = _make_loop(tmp_path / "b").run()
    assert int(resumed["step"]) == 12
    _assert_states_equal(straight["params"], resumed["params"])


def test_too_many_failures_raise(tmp_path):
    def always(step):
        raise RuntimeError("persistent failure")

    loop = _make_loop(tmp_path, failure_hook=always)
    with pytest.raises(RuntimeError, match="persistent"):
        loop.run()
    assert loop.restarts == 4


def test_restart_flushes_inflight_checkpoint_writes(tmp_path):
    """A failure at the top of step 4, right after the step-4 save went
    to the writer: the first thing after the crash is the flush, whose
    writer error is swallowed, and then the restore; the run ends
    bit-identical (the reference's event order,
    ``tests/test_checkpoint_runtime.py``)."""
    straight = _make_loop(tmp_path / "a").run()
    events = []
    bomb, crashed = _bomb_at(4, events)
    loop = _make_loop(tmp_path / "b", failure_hook=bomb)
    mgr = loop.mgr
    orig_wait, orig_restore = mgr.wait, mgr.restore_latest
    raised = {"done": False}

    def wait():
        events.append("wait_postcrash" if crashed["done"] else "wait")
        orig_wait()
        if crashed["done"] and not raised["done"]:
            raised["done"] = True
            raise OSError("flaky writer")

    def restore_latest(*a, **k):
        events.append("restore")
        return orig_restore(*a, **k)

    mgr.wait, mgr.restore_latest = wait, restore_latest
    resumed = loop.run()
    assert loop.restarts == 1 and int(resumed["step"]) == 12
    _assert_states_equal(straight["params"], resumed["params"])
    after = events[events.index("crash") + 1:]
    assert after[0] == "wait_postcrash", events
    assert "restore" in after


def test_straggler_detection(tmp_path):
    loop = _make_loop(tmp_path, total=4, deadline=1e-9)
    loop.run()
    assert loop.straggler_steps == 4 and loop.restarts == 0


def test_failed_attempt_state_is_not_reused(tmp_path):
    """A failure before the first checkpoint restarts from the seed: the
    half-run attempt's in-place updates are not carried over."""
    straight = _make_loop(tmp_path / "a", total=4, ckpt_every=4).run()
    bomb, _ = _bomb_at(3)
    resumed = _make_loop(tmp_path / "b", total=4, ckpt_every=4, failure_hook=bomb).run()
    _assert_states_equal(straight, resumed)


# ------------------------------------------------- manifold and convert --

def test_manifold_matches_reference():
    rng = np.random.default_rng(4)
    U = np.linalg.qr(rng.standard_normal((3, 40, 8)))[0].astype(np.float32)
    G = rng.standard_normal((3, 40, 8)).astype(np.float32)
    got = tman.project_tangent(torch.tensor(U), torch.tensor(G))
    ref = jman.project_tangent(jnp.asarray(U), jnp.asarray(G))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # the projection is tangent: sym(U^T PT(G)) = 0
    UtP = torch.einsum("...mk,...ml->...kl", torch.tensor(U), got)
    assert float((UtP + UtP.transpose(-1, -2)).abs().max()) < 1e-4
    s = rng.random(16).astype(np.float32)
    for k in (0, 3, 16):
        np.testing.assert_allclose(float(tman.frobenius_tail(torch.tensor(s), k)),
                                   float(jman.frobenius_tail(jnp.asarray(s), k)), rtol=1e-6)
    assert tman.orthogonality_error is orthogonality_error
    drift = U + 1e-3 * G
    np.testing.assert_allclose(float(tman.orthogonality_error(torch.tensor(drift))),
                               float(jman.orthogonality_error(jnp.asarray(drift))), atol=1e-6)


def test_convert_matches_reference():
    """Truncated SVD: s, the chosen ranks, the dense products and the
    truncation error equal the reference's (the factors' column signs are
    the backend's); the error is the Eckart-Young optimum."""
    rng = np.random.default_rng(5)
    W = (rng.standard_normal((48, 12)) @ rng.standard_normal((12, 32))
         + 0.05 * rng.standard_normal((48, 32))).astype(np.float32)
    for k in (4, 12, 32):
        got = tconv.dense_to_spectral(torch.tensor(W), k)
        ref = jconv.dense_to_spectral(jnp.asarray(W), k)
        np.testing.assert_allclose(got["s"].numpy(), np.asarray(ref["s"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tconv.spectral_to_dense(got).numpy(),
                                   np.asarray(jconv.spectral_to_dense(ref)), atol=1e-4)
        err = float(tconv.truncation_error(torch.tensor(W), got))
        assert abs(err - float(jconv.truncation_error(jnp.asarray(W), ref))) < 1e-4
        tail = float(tman.frobenius_tail(torch.linalg.svdvals(torch.tensor(W)), k))
        assert abs(err - tail) < 2e-6 * float(np.linalg.norm(W))     # fp32 products
        assert float(orthogonality_error(got["U"])) < 1e-5
    bf = tconv.dense_to_spectral(torch.tensor(W), 4, dtype=torch.bfloat16)
    assert {t.dtype for t in bf.values()} == {torch.bfloat16}
    s = np.linalg.svd(W, compute_uv=False)
    for energy in (0.5, 0.9, 0.95, 0.999, 1.0):
        assert (tconv.rank_for_energy(torch.tensor(s), energy)
                == jconv.rank_for_energy(jnp.asarray(s), energy)), energy

    stacked = np.stack([W, W[:, ::-1].copy() * 0.5]).astype(np.float32)
    tree = {"layers": {"mlp": {"up": {"w": stacked}, "down": {"w": W.T.copy()}},
                       "attn": {"wq": {"w": W}}}}
    got, granks = tconv.convert_mlp_tree_to_spectral(tree_map(torch.tensor, tree), 0.9)
    ref, rranks = jconv.convert_mlp_tree_to_spectral(jax.tree.map(jnp.asarray, tree), 0.9)
    assert granks == rranks
    assert set(got["layers"]["mlp"]["up"]) == {"U", "s", "V"}
    assert torch.equal(got["layers"]["attn"]["wq"]["w"], torch.tensor(W))
    for name in ("up", "down"):
        np.testing.assert_allclose(
            tconv.spectral_to_dense(got["layers"]["mlp"][name]).numpy(),
            np.asarray(jconv.spectral_to_dense(ref["layers"]["mlp"][name])), atol=1e-4)


# ------------------------------------------------------------------ CLI --

def test_train_cli_mixed_microbatched(tmp_path, capsys):
    train_cli.main(["--reduced", "--steps", "2", "--batch", "4", "--seq", "16",
                    "--precision", "mixed", "--microbatches", "2", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    out = capsys.readouterr().out
    assert "final ortho error" in out
    assert "loss scale: 32768  overflow-skipped steps: 0 (loop saw 0)" in out
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == ["step_00000001.npz",
                                                              "step_00000002.npz"]
    saved = load_pytree(str(tmp_path / "step_00000002.npz"))
    assert int(saved["step"]) == 2 and float(saved["loss_scale"]["scale"]) == 2.0 ** 15


def test_train_cli_dump_spec_is_the_reference_spec(tmp_path, capsys):
    flags = ["--arch", ARCH, "--reduced", "--steps", "7", "--batch", "4", "--seq", "16",
             "--precision", "mixed", "--microbatches", "2", "--ckpt-dir", str(tmp_path),
             "--ckpt-every", "3", "--seed", "2", "--lr", "0.002", "--dump-spec"]
    train_cli.main(flags)
    port = json.loads(capsys.readouterr().out)
    jax_train_cli.main(flags)
    ref = json.loads(capsys.readouterr().out)
    for section, body in port.items():
        assert ref[section] == body, section
    assert JRunSpec.from_dict(port).to_dict() == ref
    assert port["precision"] == {"mode": "mixed"} and port["train"]["microbatches"] == 2
