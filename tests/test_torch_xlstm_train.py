"""Port vs reference: training the xlstm-1.3b family (``ssm_lm``) at
reduced size on the CPU.

* The mLSTM backward's plain version (``mlstm_chunk_bwd_ref``, the CUDA
  kernel's algorithm in torch ops) against autograd through the forward's
  plain version cut into the kernel's chunks, at the fp32 rung (5e-5 of
  the reference's RMS), and against ``jax.vjp`` of the reference's chunk
  loop (``nn/xlstm.py:_mlstm_chunk_body``) at 1e-4: in fp32 for the unit
  gate profile, in fp64 (both sides) for the stabiliser profile. Its fp32
  gradients are ill-conditioned: where a row's weight sits on one token,
  y_t ~ v_j and dP_tj = (dy_t . v_j - dy_t . y_t) / den_t cancels, so two
  fp32 orders of the same sums (autograd's and the kernel's) differ there
  by ~1e-4 of the RMS; and the reference's fp32 prefix sums of log f round
  elsewhere than the port's fp64 ones, which moves every weight exp(b_t -
  b_j + i_j - m_t) by ~3e-4 (fp32 against fp64: ~2e-4 of the RMS on either
  side).
  Both profiles, with and without an initial state and gradients of the
  final state, S in {1, 37, 256, 300, 512}; the stabiliser profile has
  rows where den's floor exp(-m_loc) binds (checked).
* Loss and every gradient of ``train_loss`` against
  ``jax.value_and_grad(repro.models.model.train_loss)`` in fp32 at s 64
  and 512 (two chunks), weights from the reference's ``init_model``.
* A 10-step fp32 trajectory through both packages' ``make_train_step``,
  one legacy bf16 step, resuming a reference-written checkpoint, the
  port's own save/resume bit for bit, and the train CLI.

Gradients are compared after dividing by the reference's RMS, at rtol and
atol 1e-4, as in ``tests/test_torch_train.py``; losses at 1e-5 relative,
factors at 1e-4 absolute. The reduced model at its random init is
ill-conditioned in fp32, unlike smollm2: moving the reference's weights by
one ulp moves its own gradients by up to ~2e-3 of their RMS and, through
Adam, its losses by ~3e-3 from the fifth step. Where that spread is the
larger, the model-level comparisons hold the port to SPREAD_FACTOR times
it, measured in the test from ULP_RUNS such moves.
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
from repro.nn import xlstm as jx  # noqa: E402
from repro.optim import make_sct_optimizer as jax_make_opt  # noqa: E402
from repro_torch.api import RunSpec, Trainer  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint.store import flatten  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core.tree import max_orthogonality_error  # noqa: E402
from repro_torch.kernels.build import LAUNCHES  # noqa: E402
from repro_torch.kernels.mlstm_chunk import CHUNK, mlstm_chunk  # noqa: E402
from repro_torch.kernels.mlstm_ref import (  # noqa: E402
    init_state,
    mlstm_chunk_bwd_ref,
    mlstm_chunk_ref,
)
from repro_torch.kernels.testing import (  # noqa: E402
    MLSTM_PROFILES,
    Tol,
    assert_scaled_close,
    kernel_error,
    mlstm_inputs,
)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.optim import make_sct_optimizer  # noqa: E402

torch.set_num_threads(2)

ARCH = "xlstm-1.3b"
RUNG = Tol(rtol=5e-5, atol=5e-5)      # the fp32 rung, RMS-scaled
GRAD = Tol(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
FACTOR_ATOL = 1e-4
BF16_RTOL = 5e-2
SEQS = (1, 37, 256, 300, 512)
B, DH = 2, 32
ULP_RUNS = 2          # the reference's runs from weights one ulp away
SPREAD_FACTOR = 4


def _rel(a, b):
    return abs(float(a) / float(b) - 1.0)


def _close(got, ref, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert_scaled_close(got, np.asarray(ref), tol, err_msg=what)


def _cotangents(S, dtype, seed):
    """dy (B, S, dh) and the final state's dC, dn, dm, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape), dtype=dtype)
            for shape in ((B, S, DH), (B, DH, DH), (B, DH), (B,))]


def _jax_loop(q, k, v, i, f, C, n, m):
    """The reference's chunk body over folded (B, S, dh) inputs (one head
    a row), cut into the kernel's chunks: y and the final (C, n, m)."""
    S = q.shape[1]
    logf = jax.nn.log_sigmoid(f)
    C, n, m = C[:, None], n[:, None], m[:, None]
    outs = []
    for c0 in range(0, S, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        out, (C, n, m) = jx._mlstm_chunk_body(q[:, sl, None], k[:, sl, None], v[:, sl, None],
                                              i[:, sl, None], logf[:, sl, None], C, n, m)
        outs.append(out[:, :, 0])
    return jnp.concatenate(outs, 1), C[:, 0], n[:, 0], m[:, 0]


def _bwd_ref(inputs, state, y, cot, finals):
    dy, dC, dn, dm = cot
    q, k, v, i, f = inputs
    got = mlstm_chunk_bwd_ref(q, k, v, i, f, state, y, dy, *((dC, dn, dm) if finals
                                                              else (None,) * 3))
    return list(got[:5]) + (list(got[5]) if state is not None else [])


NAMES = ("dq", "dk", "dv", "di", "df", "dC0", "dn0", "dm0")


@pytest.mark.parametrize("finals", [False, True], ids=["dy", "dy+dstate"])
@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "state"])
@pytest.mark.parametrize("profile", MLSTM_PROFILES)
@pytest.mark.parametrize("S", SEQS)
def test_mlstm_bwd_ref_vs_autograd(S, profile, with_state, finals):
    """The plain backward against autograd through the plain forward cut
    into the same chunks (256, the last one ragged), at the fp32 rung:
    in fp32 for the unit profile, in fp64 for the stabiliser."""
    dtype = torch.float32 if profile == "unit" else torch.float64
    q, k, v, i, f, state = mlstm_inputs(B, S, DH, profile, seed=S, with_state=with_state)
    q, k, v, i, f = (t.to(dtype) for t in (q, k, v, i, f))
    state = tuple(t.to(dtype) for t in state) if with_state else None
    leaves = [t.clone().requires_grad_() for t in (q, k, v, i, f)]
    st = [t.clone().requires_grad_() for t in state] if with_state else None
    y, (C, n, m) = mlstm_chunk_ref(*leaves, st, chunk=CHUNK, ragged=True)
    cot = _cotangents(S, dtype, S + 1)
    loss = (y * cot[0]).sum()
    if finals:
        loss = loss + (C * cot[1]).sum() + (n * cot[2]).sum() + (m * cot[3]).sum()
    ref = torch.autograd.grad(loss, leaves + (st or []))
    got = _bwd_ref((q, k, v, i, f), state, y.detach(), cot, finals)
    assert len(got) == len(ref)
    for name, g, r in zip(NAMES, got, ref):
        _close(g, r.numpy(), RUNG, f"{name} S={S} {profile}")


@pytest.mark.parametrize("finals", [False, True], ids=["dy", "dy+dstate"])
@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "state"])
@pytest.mark.parametrize("profile", MLSTM_PROFILES)
@pytest.mark.parametrize("S", SEQS)
def test_mlstm_bwd_ref_vs_jax_vjp(S, profile, with_state, finals):
    """The plain backward against jax.vjp of the reference's chunk loop:
    fp32 for the unit profile, fp64 (both sides) for the stabiliser."""
    dtype = torch.float32 if profile == "unit" else torch.float64
    q, k, v, i, f, state = mlstm_inputs(B, S, DH, profile, seed=S, with_state=with_state)
    inputs = [t.to(dtype) for t in (q, k, v, i, f)]
    state = tuple(t.to(dtype) for t in state) if with_state else None
    st0 = state if with_state else init_state(B, DH, device="cpu", dtype=dtype)
    cot = _cotangents(S, dtype, S + 1)
    if not finals:
        cot[1:] = [torch.zeros_like(t) for t in cot[1:]]
    with jax.enable_x64(dtype == torch.float64):
        args = [jnp.asarray(t.numpy()) for t in (*inputs, *st0)]
        _, vjp = jax.vjp(_jax_loop, *args)
        ref = [np.asarray(g) for g in vjp(tuple(jnp.asarray(c.numpy()) for c in cot))]
    assert ref[0].dtype == inputs[0].numpy().dtype
    y, _ = mlstm_chunk_ref(*inputs, state, chunk=CHUNK, ragged=True)
    got = _bwd_ref(inputs, state, y, cot, finals)
    for name, g, r in zip(NAMES, got, ref):
        _close(g, r, GRAD, f"{name} S={S} {profile}")


def test_stabiliser_profile_binds_the_floor():
    """The stabiliser cases reach both branches of den = max(|den_raw|,
    exp(-m_loc)): rows where the floor binds exist, and so do rows where
    it does not (the first chunk of the S = 37 and S = 256 draws)."""
    for S in (37, 256):
        q, k, v, i, f, _ = mlstm_inputs(B, S, DH, "stabiliser", seed=S)
        bcum = torch.cumsum(torch.nn.functional.logsigmoid(f).double(), 1).float()
        logD = bcum[:, :, None] - bcum[:, None, :] + i[:, None, :]
        logD = logD.masked_fill(~torch.tril(torch.ones(S, S, dtype=torch.bool)), -torch.inf)
        m_loc = torch.amax(logD, 2)              # the empty state: inter is -1e30
        w = torch.exp(logD - m_loc[..., None])
        den_raw = (w * torch.einsum("btd,bjd->btj", q, k)).sum(2)
        floor = torch.exp(-m_loc)
        assert bool((floor > den_raw.abs()).any()) and bool((floor < den_raw.abs()).any())


def test_kernel_wrapper_backward_on_cpu_is_the_plain_version():
    """Under autograd on CPU tensors the wrapper's backward is
    mlstm_chunk_bwd_ref, the final state's unused gradients arrive as None,
    and the backward kernel's launch count does not move."""
    q, k, v, i, f, state = mlstm_inputs(B, 300, DH, "unit", seed=3, with_state=True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, i, f, *state)]
    before = LAUNCHES["mlstm_chunk_bwd"]
    y, _ = mlstm_chunk(*leaves[:5], tuple(leaves[5:]))
    dy = _cotangents(300, torch.float32, 4)[0]
    grads = torch.autograd.grad((y * dy).sum(), leaves)
    yr, _ = mlstm_chunk_ref(q, k, v, i, f, state)
    ref = mlstm_chunk_bwd_ref(q, k, v, i, f, state, yr, dy, None, None, None)
    for name, g, r in zip(NAMES, grads, list(ref[:5]) + list(ref[5])):
        assert torch.equal(g, r), name
    assert LAUNCHES["mlstm_chunk_bwd"] == before


# ------------------------------------------------------------------ model --

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


def _ulp_moved(tree, seed):
    """``tree`` with every fp32 leaf moved one ulp up or down at random: the
    least change of the weights there is."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        to = np.where(rng.random(a.shape) < 0.5, np.float32(np.inf), np.float32(-np.inf))
        return jnp.asarray(np.nextafter(a, to.astype(np.float32)))
    return jax.tree.map(move, tree)


def _spread_tol(base, spread):
    """The tolerance of one comparison: ``base``, or SPREAD_FACTOR times
    how far the reference's own result moves when its weights move one
    ulp, where that is larger."""
    return max(base, SPREAD_FACTOR * spread)


@pytest.mark.parametrize("s", [64, 512])
def test_loss_and_grads_match_reference(s):
    """fp32 at s 64 (one chunk) and 512 (two: the carried state's
    gradients cross the chunk boundary), remat on as in the config. The
    loss at 1e-5; each gradient at 1e-4 of the reference's RMS, or at
    SPREAD_FACTOR times the reference's own spread under one-ulp moves of
    its weights where that is larger (the model at its random init is
    ill-conditioned in fp32: a row of the mLSTM's output that cancels is
    scaled back up by the RMSNorm after it, and one ulp on the weights
    moves the reference's gradients by up to ~2e-3 of their RMS)."""
    jcfg, tcfg = _cfgs(dtype="float32", max_seq=s)
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batch(jcfg.vocab, s, 0, 2)
    value_and_grad = jax.jit(jax.value_and_grad(jm.train_loss, has_aux=True), static_argnums=2)
    (loss_ref, _), grads_ref = value_and_grad(jp, jb, jcfg)
    ref = {key: np.asarray(r) for key, r in flatten(jax.device_get(grads_ref)).items()}
    moved = [flatten(jax.device_get(value_and_grad(_ulp_moved(jp, seed), jb, jcfg)[1]))
             for seed in range(ULP_RUNS)]
    leaves = {key: t.requires_grad_() for key, t in flatten(tp).items()}
    loss, _ = tm.train_loss(tp, tb, tcfg)
    loss.backward()
    assert _rel(loss.detach(), loss_ref) < LOSS_RTOL
    assert sorted(ref) == sorted(leaves)
    for key, r in ref.items():
        g = leaves[key].grad
        assert g is not None and bool(torch.isfinite(g).all()), key
        spread = max(kernel_error(np.asarray(m[key]), r).max_scaled for m in moved)
        tol = _spread_tol(GRAD.atol, spread)
        _close(g, r, Tol(tol, tol), f"{key} (tolerance {tol:.2e})")


def _jax_trajectory(jcfg, jp, steps, seq, batch, **kw):
    jopt = jax_make_opt(jcfg, **kw)
    jstate, jstep = jopt.init(jp), jax.jit(jax_make_train_step(jcfg, jopt))
    losses = []
    for i in range(steps):
        jstate, met = jstep(jstate, _batch(jcfg.vocab, seq, i, batch)[0])
        losses.append(float(met["loss"]))
    return losses, jstate


def _trajectory(steps, seq=64, batch=4, ulp_runs=0, **opt_kw):
    """The port's and the reference's losses and final states over
    ``steps``, and the reference's again from ``ulp_runs`` one-ulp moves of
    its initial weights."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    kw = dict(lr=1e-3, warmup=3, total_steps=steps, **opt_kw)
    topt = make_sct_optimizer(tcfg, **kw)
    tstate, tstep = topt.init(tp), make_train_step(tcfg, topt)
    losses = []
    for i in range(steps):
        tstate, met = tstep(tstate, _batch(jcfg.vocab, seq, i, batch)[1])
        losses.append(float(met["loss"]))
    jlosses, jstate = _jax_trajectory(jcfg, jp, steps, seq, batch, **kw)
    moved = [_jax_trajectory(jcfg, _ulp_moved(jp, seed), steps, seq, batch, **kw)
             for seed in range(ulp_runs)]
    return list(zip(losses, jlosses)), tstate, jstate, moved


def test_fp32_trajectory_matches_reference():
    """Ten fp32 steps. Losses at 1e-5 relative and factors at 1e-4, or at
    SPREAD_FACTOR times the reference's own spread over one-ulp moves of
    its initial weights where that is larger: Adam's first updates are
    near sign(g), so a gradient at the fp32 noise floor flips an update of
    lr, and from the fifth step the reference's own losses move by ~3e-3
    (1e-2 at the eighth)."""
    losses, tstate, jstate, moved = _trajectory(10, ulp_runs=ULP_RUNS, precision="fp32")
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


def test_bf16_legacy_step_matches_reference():
    losses, _, _, _ = _trajectory(1)           # reduced config: bf16 compute, legacy
    (got, ref), = losses
    assert np.isfinite(got) and _rel(got, ref) < BF16_RTOL


def _spec(directory, steps=6, cls=RunSpec):
    return cls.from_dict({
        "model": {"arch": ARCH, "reduced": True},
        "train": {"steps": steps, "batch": 2, "seq": 32, "lr": 1e-3},
        "precision": {"mode": "fp32"},
        "checkpoint": {"directory": str(directory), "every": 3},
    })


def test_resume_from_reference_checkpoint(tmp_path):
    """The reference's Trainer writes the period tree (npz); the port
    resumes it and reproduces the next three losses."""
    jtrainer = JTrainer(_spec(tmp_path / "jax", cls=JRunSpec))
    for _ in range(3):
        jtrainer.step()
    assert jtrainer.save() == 3
    jax_losses = [float(jtrainer.step()["loss"]) for _ in range(3)]
    trainer = Trainer.resume(str(tmp_path / "jax"), device="cpu")
    assert trainer.current_step == 3
    assert any(key.startswith("periods/") for key in flatten(trainer.params))
    losses = [float(trainer.step()["loss"]) for _ in range(3)]
    for i, (got, ref) in enumerate(zip(losses, jax_losses)):
        assert _rel(got, ref) < LOSS_RTOL, f"step {i + 4}: {got} vs {ref}"


def test_save_and_resume_are_bit_identical(tmp_path):
    straight = Trainer(_spec(tmp_path / "a"), device="cpu")
    losses = [float(straight.step()["loss"]) for _ in range(6)]
    first = Trainer(_spec(tmp_path / "b"), device="cpu")
    head = [float(first.step()["loss"]) for _ in range(3)]
    first.save()
    resumed = Trainer.resume(str(tmp_path / "b"), device="cpu")
    tail = [float(resumed.step()["loss"]) for _ in range(3)]
    assert head + tail == losses
    final = Trainer.resume(str(tmp_path / "b"), device="cpu").fit()
    assert int(final["step"]) == 6
    for key, t in flatten(final["params"]).items():
        assert torch.equal(t, flatten(straight.params)[key]), key


def test_train_cli_trains_xlstm_on_cpu_and_needs_a_device(tmp_path, capsys, monkeypatch):
    train_cli.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
                    "--device", "cpu", "--ckpt-dir", str(tmp_path / "run")])
    assert "final ortho error" in capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "run").glob("*.npz")) == ["step_00000002.npz"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", ARCH, "--reduced", "--steps", "1",
                        "--ckpt-dir", str(tmp_path / "gpu")])
