"""Port vs reference: precision policies and dynamic loss scaling at
reduced size on the CPU.

* The presets, the policy resolution, ``cast_tree``, ``all_finite`` and
  ``unscale_grads`` equal the reference's; ``loss_scale_update`` over
  sequences of finite and overflowed steps gives the reference's state
  exactly, step by step.
* ``mixed`` tracks ``fp32`` over 30 steps within the reference's own
  bounds (``tests/test_precision.py``), with no spurious skip, fp32
  masters and orthonormal factors.
* The ``mixed`` trajectory against the reference's (the same weights
  through ``bridge.py``, the same batches): the loss-scale state exactly
  at every step, losses within the bf16 rung (5e-2 relative), and every
  parameter's change over the run within the bf16 rung of the
  reference's change, or 4x the reference's own spread over one-ulp moves
  of its initial weights where that is larger.
* The ``bf16`` policy: parameters stay bf16, orthonormal to bf16's
  tolerance, 6 steps within the bf16 rung of the reference's, parameter
  changes held as under ``mixed``.
* One optimizer step pair on the same state and gradients in both
  packages: under ``mixed`` the changes at the fp32 rung, under ``bf16``
  every element within one bf16 ulp.
* An injected overflow leaves parameters and moments bit for bit,
  halves the scale, counts the skip and advances the step.
* A state written under one policy trains under another (both
  directions, in memory and through a checkpoint), as the reference's
  degrades.
* Checkpoints: a bf16 leaf round trips through the port's file bit for
  bit, the reference's ``V2`` bf16 file reads back as bf16 bits, a bf16
  run resumes bit for bit, and the port resumes a ``mixed`` checkpoint
  the reference wrote.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import Trainer as JTrainer  # noqa: E402
from repro.checkpoint.store import save_pytree as jax_save_pytree  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.data.synthetic import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.optim import make_sct_optimizer as jax_make_opt  # noqa: E402
from repro_torch.api import RunSpec, Trainer  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint.store import (  # noqa: E402
    flatten,
    load_pytree,
    save_pytree,
    to_tensor,
    unflatten,
)
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core.tree import max_orthogonality_error  # noqa: E402
from repro_torch.kernels.testing import TOLERANCE_LADDER  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.optim import make_sct_optimizer  # noqa: E402

torch.set_num_threads(2)

ARCH = "smollm2-135m"
BF16_RTOL = 5e-2
ORTHO_BF16 = 0.08          # the reference's bf16 orthonormality tolerance
ORTHO_FP32 = 5e-5          # fp32 masters (the 30-step mixed-vs-fp32 bound)
ULP_RUNS = 2               # the reference's runs from weights one ulp away
SPREAD_FACTOR = 4
APPLY_BF16_MISMATCH = 1e-3
FASTGROW = dict(name="mixed-fastgrow", compute_dtype="bfloat16", loss_scaling=True,
                init_scale=2.0 ** 10, growth_interval=3)


def _rel(a, b):
    return abs(float(a) / float(b) - 1.0)


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


def _policies(precision):
    """(reference policy, port policy) for a preset name or FASTGROW."""
    if precision == "fastgrow":
        return jprec.PrecisionPolicy(**FASTGROW), tprec.PrecisionPolicy(**FASTGROW)
    return precision, precision


def _ls_numpy(ls):
    return {k: np.asarray(v) for k, v in ls.items()}


# ------------------------------------------------------------ policies --

def test_presets_match_reference():
    assert set(tprec.POLICIES) == set(jprec.POLICIES)
    for name, pol in tprec.POLICIES.items():
        assert dataclasses.asdict(pol) == dataclasses.asdict(jprec.POLICIES[name]), name
    mixed = tprec.POLICIES["mixed"]
    assert (mixed.param_dtype, mixed.compute_dtype, mixed.accum_dtype) == (
        "float32", "bfloat16", "float32") and mixed.loss_scaling
    assert tprec.POLICIES["bf16"].param_torch == torch.bfloat16
    assert tprec.LEGACY == jprec.LEGACY


def test_precision_policy_resolution():
    for name in ("fp32", "bf16", "mixed"):
        assert tprec.precision_policy(name) is tprec.POLICIES[name]
    assert tprec.precision_policy(None) is None and tprec.precision_policy("legacy") is None
    pol = tprec.PrecisionPolicy(name="custom")
    assert tprec.precision_policy(pol) is pol
    with pytest.raises(ValueError):
        tprec.precision_policy("fp64")
    _, tcfg = _cfgs()
    eff = tprec.effective_policy(tcfg, "legacy")
    assert (eff.name, eff.compute_dtype, eff.loss_scaling) == ("legacy", tcfg.dtype, False)


def test_cast_tree_and_all_finite_match_reference():
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "n": {"step": np.zeros((), np.int32), "b": rng.standard_normal(5).astype(np.float32)}}
    t = {"w": torch.tensor(tree["w"]),
         "n": {"step": torch.tensor(tree["n"]["step"]), "b": torch.tensor(tree["n"]["b"])}}
    out, ref = tprec.cast_tree(t, torch.bfloat16), jprec.cast_tree(tree, jnp.bfloat16)
    assert out["w"].dtype == torch.bfloat16 and out["n"]["step"].dtype == torch.int32
    np.testing.assert_array_equal(out["w"].view(torch.int16).numpy(),
                                  np.asarray(ref["w"]).view(np.int16))
    for bad in (None, np.inf, -np.inf, np.nan):
        tt = {k: v for k, v in t.items()}
        w = t["w"].clone()
        if bad is not None:
            w[1, 2] = bad
        tt["w"] = w
        got = tprec.all_finite(tt)
        assert got.dtype == torch.bool and got.shape == ()
        assert bool(got) == bool(jprec.all_finite(
            {"w": jnp.asarray(w.numpy()), "n": tree["n"]})) == (bad is None)
    assert bool(tprec.all_finite({"i": torch.zeros(3, dtype=torch.int32)}))


def test_unscale_grads_matches_reference():
    rng = np.random.default_rng(1)
    g = rng.standard_normal((6, 5)).astype(np.float32) * 2.0 ** 15
    gb = torch.tensor(g).bfloat16()
    ls_t = tprec.loss_scale_init(tprec.POLICIES["mixed"])
    ls_j = jprec.loss_scale_init(jprec.POLICIES["mixed"])
    tg = torch.tensor(g)
    out = tprec.unscale_grads({"a": tg, "b": gb}, ls_t)
    ref = jprec.unscale_grads({"a": jnp.asarray(g), "b": jnp.asarray(gb.float().numpy(),
                                                                      jnp.bfloat16)}, ls_j)
    assert out["a"] is tg                       # fp32: in place
    assert out["b"].dtype == torch.float32 and gb.dtype == torch.bfloat16
    for k in ("a", "b"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("seq", [
    "FFFFFFFFFF", "FFOFFFOOFF", "OOOOOOOOOOOOOOOOOOOFFFFFFF", "FOFOFOFOFO",
    "FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF"])
def test_loss_scale_update_matches_reference(seq):
    """Finite (F) and overflowed (O) steps under a policy whose scale
    grows every 2 finite steps, floored at 1 and capped at 2^13: the state
    equals the reference's exactly after every step, and the given state
    is left as it was."""
    kw = dict(name="t", loss_scaling=True, init_scale=2.0 ** 10, growth_interval=2,
              min_scale=1.0, max_scale=2.0 ** 13)
    tpol, jpol = tprec.PrecisionPolicy(**kw), jprec.PrecisionPolicy(**kw)
    ls_t, ls_j = tprec.loss_scale_init(tpol), jprec.loss_scale_init(jpol)
    for c in seq:
        before = {k: v.clone() for k, v in ls_t.items()}
        new = tprec.loss_scale_update(ls_t, torch.tensor(c == "F"), tpol)
        assert all(torch.equal(before[k], ls_t[k]) for k in ls_t)
        ls_t, ls_j = new, jprec.loss_scale_update(ls_j, jnp.bool_(c == "F"), jpol)
        assert {k: v.dtype for k, v in ls_t.items()} == {
            "scale": torch.float32, "good_steps": torch.int32, "skipped": torch.int32}
        for k, v in _ls_numpy(ls_j).items():
            np.testing.assert_array_equal(ls_t[k].numpy(), v, err_msg=f"{seq}: {k}")
    assert int(ls_t["skipped"]) == seq.count("O")


# --------------------------------------------------------- trajectories --

def _train_port(precision, steps, lr=3e-3, batch=8, seq=32):
    _, tcfg = _cfgs()
    _, tp = _params(*_cfgs())
    opt = make_sct_optimizer(tcfg, lr=lr, warmup=4, total_steps=steps, precision=precision)
    step_fn = make_train_step(tcfg, opt)
    state = opt.init(tp)
    losses = []
    for i in range(steps):
        state, m = step_fn(state, _batch(tcfg.vocab, seq, i, batch)[1])
        losses.append(float(m["loss"]))
    return state, losses


def test_mixed_tracks_fp32_30_steps():
    """The reference's own regression (``tests/test_precision.py``) on the
    port: mixed learns, tracks fp32 (last loss within 0.25, every loss
    within 0.5), no spurious skip, masters fp32, factors orthonormal."""
    state_m, loss_m = _train_port("mixed", 30)
    _, loss_f = _train_port("fp32", 30)
    assert np.isfinite(loss_m).all() and np.isfinite(loss_f).all()
    assert loss_m[-1] < loss_m[0] - 0.1
    assert abs(loss_m[-1] - loss_f[-1]) < 0.25
    assert np.max(np.abs(np.asarray(loss_m) - np.asarray(loss_f))) < 0.5
    assert int(state_m["loss_scale"]["skipped"]) == 0
    assert {t.dtype for t in flatten(state_m["params"]).values()} == {torch.float32}
    assert {t.dtype for t in flatten(state_m["opt"]).values()} <= {torch.float32, torch.int32}
    assert float(max_orthogonality_error(state_m["params"])) < ORTHO_FP32


def _ulp_moved(tree, seed):
    """``tree`` with every fp32 leaf moved one ulp up or down at random."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        to = np.where(rng.random(a.shape) < 0.5, np.float32(np.inf), np.float32(-np.inf))
        return jnp.asarray(np.nextafter(a, to.astype(np.float32)))
    return jax.tree.map(move, tree)


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


def _fp32_leaves(tree):
    """fp32 numpy copies of ``tree``'s leaves (copies: the port's step
    updates fp32 tensors in place)."""
    return {k: np.array(v.float().numpy() if isinstance(v, torch.Tensor)
                        else jax.device_get(v), np.float32)
            for k, v in flatten(tree).items()}


def _both_trajectories(precision, steps, seq=32, batch=4, ulp_runs=0):
    """Both packages' trajectories under ``precision`` from the same
    weights: per-step metrics and loss-scale states, the final states, the
    initial parameters (fp32 leaves, as the policy casts them), and the
    reference's final parameters again from ``ulp_runs`` one-ulp moves of
    its initial fp32 weights."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    jpol, tpol = _policies(precision)
    kw = dict(lr=1e-3, warmup=3, total_steps=steps)
    jopt = jax_make_opt(jcfg, precision=jpol, **kw)
    topt = make_sct_optimizer(tcfg, precision=tpol, **kw)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    init = _fp32_leaves(tstate["params"])
    jstep, tstep = jax.jit(jax_make_train_step(jcfg, jopt)), make_train_step(tcfg, topt)
    rows = []
    for i in range(steps):
        jb, tb = _batch(jcfg.vocab, seq, i, batch)
        jstate, jmet = jstep(jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        rows.append((tmet, jmet, {k: v.clone() for k, v in tstate.get("loss_scale", {}).items()},
                     _ls_numpy(jstate["loss_scale"]) if "loss_scale" in jstate else {}))
    moved = []
    for seed in range(ulp_runs):
        mstate = jopt.init(_ulp_moved(jp, seed))
        for i in range(steps):
            mstate, _ = jstep(mstate, _batch(jcfg.vocab, seq, i, batch)[0])
        moved.append(_fp32_leaves(mstate["params"]))
    return rows, tstate, jstate, init, moved


def _assert_changes_match(tstate, jstate, init, moved):
    """Every leaf's change over the run within the bf16 rung of the
    reference's change (its RMS the unit), or SPREAD_FACTOR times the
    reference's own spread over one-ulp moves of its initial weights where
    that is larger; a leaf the reference left as it was stays so."""
    got, ref = _fp32_leaves(tstate["params"]), _fp32_leaves(jstate["params"])
    for key, t in got.items():
        spread = max(_change_error(m[key], ref[key], init[key]) for m in moved)
        err = _change_error(t, ref[key], init[key])
        assert err <= max(BF16_RTOL, SPREAD_FACTOR * spread), f"{key}: {err} (spread {spread})"


@pytest.mark.parametrize("precision", ["mixed", "fastgrow"])
def test_mixed_trajectory_matches_reference(precision):
    """Eight steps under ``mixed`` (and a policy whose scale grows every 3
    steps): the loss-scale state equals the reference's exactly at every
    step; loss, its scale and overflow flag as the reference reports
    them, losses within the bf16 rung; every parameter's change over the
    run within the bf16 rung of the reference's (``_assert_changes_match``);
    masters fp32 and factors orthonormal."""
    rows, tstate, jstate, init, moved = _both_trajectories(precision, 8, ulp_runs=ULP_RUNS)
    for i, (tmet, jmet, ls_t, ls_j) in enumerate(rows):
        assert set(tmet) == set(jmet) >= {"loss", "ce_loss", "loss_scale", "overflow"}
        for k, v in ls_j.items():
            np.testing.assert_array_equal(ls_t[k].numpy(), v, err_msg=f"step {i + 1}: {k}")
        assert float(tmet["loss_scale"]) == float(jmet["loss_scale"])
        assert float(tmet["overflow"]) == float(jmet["overflow"]) == 0.0
        assert np.isfinite(float(tmet["loss"])) and _rel(tmet["loss"], jmet["loss"]) < BF16_RTOL
    if precision == "fastgrow":
        assert float(tstate["loss_scale"]["scale"]) == 2.0 ** 12
    _assert_changes_match(tstate, jstate, init, moved)
    assert {t.dtype for t in flatten(tstate["params"]).values()} == {torch.float32}
    assert float(max_orthogonality_error(tstate["params"])) < ORTHO_FP32


def test_bf16_policy_matches_reference():
    """Six steps under ``bf16``: parameters and their updates stay bf16,
    orthonormal to bf16's tolerance; losses within the bf16 rung of the
    reference's, whose parameters stay bf16 too; every parameter's change
    over the run as the reference's (``_assert_changes_match``)."""
    rows, tstate, jstate, init, moved = _both_trajectories("bf16", 6, ulp_runs=ULP_RUNS)
    for i, (tmet, jmet, _, _) in enumerate(rows):
        assert "loss_scale" not in tmet
        assert np.isfinite(float(tmet["loss"])) and _rel(tmet["loss"], jmet["loss"]) < BF16_RTOL, i
    assert {t.dtype for t in flatten(tstate["params"]).values()} == {torch.bfloat16}
    assert {leaf.dtype for leaf in jax.tree.leaves(jstate["params"])} == {jnp.dtype(jnp.bfloat16)}
    _assert_changes_match(tstate, jstate, init, moved)
    assert float(max_orthogonality_error(tstate["params"])) < ORTHO_BF16


@pytest.mark.parametrize("precision", ["mixed", "bf16"])
def test_optimizer_apply_matches_reference(precision):
    """Two optimizer steps on the same state and the same gradients in
    both packages (under ``mixed`` the gradients carry the loss scale, under
    ``bf16`` they are bf16): unscale, clip, AdamW, the rounding of bf16
    leaves and the retraction, without the forward's rounding. Under
    ``mixed`` every leaf's change within the fp32 rung of the reference's
    change (its RMS the unit; ~2e-5 measured) and the loss-scale state
    exact. Under ``bf16`` every element within one bf16 ulp of the
    reference's and at most APPLY_BF16_MISMATCH of them off (the
    retraction's last bits; 3 of 82336 measured)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    kw = dict(lr=1e-3, warmup=0, total_steps=10, precision=precision)
    jopt, topt = jax_make_opt(jcfg, **kw), make_sct_optimizer(tcfg, **kw)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    init = _fp32_leaves(tstate["params"])
    tdtype, jdtype = ((torch.bfloat16, jnp.bfloat16) if precision == "bf16"
                      else (torch.float32, jnp.float32))
    scale = float(tstate["loss_scale"]["scale"]) if precision == "mixed" else 1.0
    rng = np.random.default_rng(5)
    japply = jax.jit(jopt.apply)
    for _ in range(2):
        g = {k: (rng.standard_normal(v.shape) * 1e-2 * scale).astype(np.float32)
             for k, v in init.items()}
        tstate = topt.apply(tstate, unflatten({k: torch.tensor(v).to(tdtype)
                                               for k, v in g.items()}))
        jstate = japply(jstate, unflatten({k: jnp.asarray(v, jdtype) for k, v in g.items()}))
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    if precision == "mixed":
        for k, v in _ls_numpy(jstate["loss_scale"]).items():
            np.testing.assert_array_equal(tstate["loss_scale"][k].numpy(), v, err_msg=k)
        got, ref = _fp32_leaves(tstate["params"]), _fp32_leaves(jstate["params"])
        for key, t in got.items():
            err = _change_error(t, ref[key], init[key])
            assert err <= TOLERANCE_LADDER[torch.float32].atol, f"{key}: {err}"
        return
    off, total = 0, 0
    ref = flatten(jax.device_get(jstate["params"]))
    for key, t in flatten(tstate["params"]).items():
        assert t.dtype == torch.bfloat16, key
        ulps = np.abs(t.view(torch.int16).numpy().astype(np.int32)
                      - np.asarray(ref[key]).view(np.int16).astype(np.int32))
        assert ulps.max() <= 1, f"{key}: {ulps.max()} ulps"
        off, total = off + int(np.count_nonzero(ulps)), total + ulps.size
    assert off <= APPLY_BF16_MISMATCH * total, f"{off} of {total} elements off by one ulp"


def test_overflow_skips_step_and_halves_scale():
    """Injected overflow: parameters and moments bit for bit as they were
    (compared against clones: the step works in place), the scale halved,
    the skip counted, the step advanced; a finite step afterwards updates
    the parameters again and counts no skip."""
    _, tcfg = _cfgs()
    _, tp = _params(*_cfgs())
    opt = make_sct_optimizer(tcfg, lr=3e-3, precision="mixed")
    state = opt.init(tp)
    before = {k: v.clone() for k, v in flatten(state).items()}
    scale0 = float(state["loss_scale"]["scale"])
    bad = {k: torch.full_like(v, np.inf) for k, v in flatten(state["params"]).items()}
    bad[next(iter(bad))].fill_(np.nan)
    new = opt.apply(state, unflatten(bad))
    after = flatten(new)
    for key in flatten(state["params"]):
        for part in ("params/", "opt/mu/", "opt/nu/"):
            assert torch.equal(after[part + key], before[part + key]), part + key
    assert float(new["loss_scale"]["scale"]) == scale0 / 2
    assert int(new["loss_scale"]["skipped"]) == 1 and int(new["loss_scale"]["good_steps"]) == 0
    assert int(new["step"]) == 1 and int(new["opt"]["count"]) == 0
    held = {k: v.clone() for k, v in flatten(new["params"]).items()}
    good = unflatten({k: torch.ones_like(v) * float(new["loss_scale"]["scale"])
                      for k, v in flatten(state["params"]).items()})
    later = opt.apply(new, good)
    assert any(not torch.equal(v, held[k]) for k, v in flatten(later["params"]).items())
    assert int(later["loss_scale"]["skipped"]) == 1 and int(later["step"]) == 2


def test_precision_mismatched_state_degrades_as_reference():
    """An fp32 state under the mixed optimizer takes the unscaled path (no
    loss_scale appears); a mixed state under the legacy optimizer carries
    its loss_scale untouched and applies the unscaled update, equal to the
    legacy step's from the same parameters, bit for bit. Each loss is the
    reference's for the same pairing."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batch(tcfg.vocab, 16, 0, 4)
    t_opt = {p: make_sct_optimizer(tcfg, lr=1e-3, precision=p) for p in ("fp32", "mixed", None)}
    j_opt = {p: jax_make_opt(jcfg, lr=1e-3, precision=p) for p in ("fp32", "mixed", None)}

    def clone_params():
        return {k: v.clone() for k, v in flatten(tp).items()}

    s, m = make_train_step(tcfg, t_opt["mixed"])(t_opt["fp32"].init(unflatten(clone_params())), tb)
    js, jmet = jax.jit(jax_make_train_step(jcfg, j_opt["mixed"]))(j_opt["fp32"].init(jp), jb)
    assert "loss_scale" not in s and "loss_scale" not in js and "loss_scale" not in m
    assert abs(float(m["loss"]) - float(jmet["loss"])) < BF16_RTOL * abs(float(jmet["loss"]))

    state_m = t_opt["mixed"].init(unflatten(clone_params()))
    s, m = make_train_step(tcfg, t_opt[None])(state_m, tb)
    assert np.isfinite(float(m["loss"])) and "loss_scale" not in m
    assert float(s["loss_scale"]["scale"]) == 2.0 ** 15 and int(s["loss_scale"]["skipped"]) == 0
    s_ref, _ = make_train_step(tcfg, t_opt[None])(
        t_opt[None].init(unflatten(clone_params())), tb)
    for key, t in flatten(s["params"]).items():
        assert torch.equal(t, flatten(s_ref["params"])[key]), key
    js, jmet = jax.jit(jax_make_train_step(jcfg, j_opt[None]))(j_opt["mixed"].init(jp), jb)
    assert float(js["loss_scale"]["scale"]) == 2.0 ** 15
    assert _rel(m["loss"], jmet["loss"]) < BF16_RTOL


# ---------------------------------------------------------- checkpoints --

def test_bf16_leaf_round_trips_in_both_packages(tmp_path):
    """The port writes a bf16 leaf as the reference does (its bits as a
    2-byte void) and reads it back bit for bit; the reference's ``V2``
    file reads as the same bf16 bits."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((4, 7)).astype(np.float32)).bfloat16()
    x[0, 0], x[0, 1] = float("inf"), float("nan")
    tree = {"a": x, "n": {"step": torch.tensor(5, dtype=torch.int32),
                          "f": torch.arange(3, dtype=torch.float32)}}
    save_pytree(tree, str(tmp_path / "port.npz"))
    back = load_pytree(str(tmp_path / "port.npz"))
    assert back["a"].dtype == np.dtype("V2")
    got = to_tensor(back["a"])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), x.view(torch.int16))
    assert torch.equal(to_tensor(back["n"]["step"]), tree["n"]["step"])
    assert torch.equal(to_tensor(back["n"]["f"]), tree["n"]["f"])

    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jax_save_pytree({"a": jx}, str(tmp_path / "ref.npz"))
    ref = load_pytree(str(tmp_path / "ref.npz"))["a"]
    assert ref.dtype.kind == "V" and ref.dtype.itemsize == 2
    np.testing.assert_array_equal(ref.view(np.int16), np.asarray(jx).view(np.int16))
    assert torch.equal(to_tensor(ref).view(torch.int16), x.view(torch.int16))
    # the weight bridge takes the reference's in-memory bf16 arrays too
    assert torch.equal(to_tensor(np.asarray(jax.device_get(jx))).view(torch.int16),
                       x.view(torch.int16))


def _spec(directory, precision, steps=6, cls=RunSpec):
    return cls.from_dict({
        "model": {"arch": ARCH, "reduced": True},
        "train": {"steps": steps, "batch": 2, "seq": 32, "lr": 1e-3},
        "precision": {"mode": precision},
        "checkpoint": {"directory": str(directory), "every": 3},
    })


@pytest.mark.parametrize("precision", ["bf16", "mixed"])
def test_save_and_resume_are_bit_identical(tmp_path, precision):
    """A run saved at step 3 and resumed gives the uninterrupted run's
    losses and its final state (parameters, moments, loss scale) bit for
    bit; under bf16 through the bf16 checkpoint layout."""
    straight = Trainer(_spec(tmp_path / "a", precision), device="cpu")
    losses = [float(straight.step()["loss"]) for _ in range(6)]
    first = Trainer(_spec(tmp_path / "b", precision), device="cpu")
    for _ in range(3):
        first.step()
    first.save()
    saved = load_pytree(str(tmp_path / "b" / "step_00000003.npz"))
    if precision == "bf16":
        assert {a.dtype for a in flatten(saved["params"]).values()} == {np.dtype("V2")}
    else:
        assert set(saved["loss_scale"]) == {"scale", "good_steps", "skipped"}
    resumed = Trainer.resume(str(tmp_path / "b"), device="cpu")
    tail = [float(resumed.step()["loss"]) for _ in range(3)]
    assert tail == losses[3:]
    final = flatten(resumed.state)
    for key, t in flatten(straight.state).items():
        assert t.dtype == final[key].dtype and torch.equal(t, final[key]), key


def test_resume_from_reference_mixed_checkpoint(tmp_path):
    """The reference's Trainer under ``mixed`` saves at step 3; the port
    resumes it: the loss-scale state as written, then three steps whose
    losses sit within the bf16 rung of the reference's and whose
    loss-scale states equal its exactly."""
    jtrainer = JTrainer(_spec(tmp_path, "mixed", cls=JRunSpec))
    for _ in range(3):
        jtrainer.step()
    assert jtrainer.save() == 3
    jrows = []
    for _ in range(3):
        m = jtrainer.step()
        jrows.append((float(m["loss"]), _ls_numpy(jtrainer.state["loss_scale"])))

    trainer = Trainer.resume(str(tmp_path), device="cpu")
    assert trainer.spec.precision.mode == "mixed" and trainer.current_step == 3
    assert float(trainer.state["loss_scale"]["scale"]) == 2.0 ** 15
    for i, (loss_ref, ls_ref) in enumerate(jrows):
        m = trainer.step()
        assert _rel(m["loss"], loss_ref) < BF16_RTOL, i
        for k, v in ls_ref.items():
            np.testing.assert_array_equal(trainer.state["loss_scale"][k].numpy(), v)


@pytest.mark.parametrize("written,resumed", [("fp32", "mixed"), ("mixed", "legacy")])
def test_precision_mismatched_checkpoint_resumes(tmp_path, written, resumed):
    """A checkpoint written under one policy resumes under another through
    ``Trainer.resume(..., **{"precision.mode": ...})``: an fp32 state under
    ``mixed`` trains unscaled (no loss scale appears), a mixed state under
    ``legacy`` carries its loss scale as it was written."""
    first = Trainer(_spec(tmp_path, written), device="cpu")
    for _ in range(3):
        first.step()
    first.save()
    trainer = Trainer.resume(str(tmp_path), device="cpu", **{"precision.mode": resumed})
    assert trainer.spec.precision.mode == resumed and trainer.current_step == 3
    for _ in range(2):
        m = trainer.step()
        assert np.isfinite(float(m["loss"])) and "loss_scale" not in m
    assert ("loss_scale" in trainer.state) == (written == "mixed")
    if written == "mixed":
        saved = load_pytree(str(tmp_path / "step_00000003.npz"))["loss_scale"]
        for k, v in trainer.state["loss_scale"].items():
            np.testing.assert_array_equal(v.numpy(), saved[k])
    assert int(trainer.state["step"]) == 5
