"""Port vs reference: the serving CLI's static mode and its spec.

``run_static`` (one batch of prompts, one prefill, batched greedy decode
steps over the dense static cache) gives the reference's
``src/repro/launch/serve.py:run_static`` tokens, token for token in fp32,
on the same prompts (the reference draws them with ``jax.random``; here
its draw is replaced by the port's prompts), plain and over the int8
tree; ``--quantize int8 --verify`` passes (fp32: token for token against
the static path over the dequantized weights; bf16: within the ladder,
teacher-forced). ``--dump-spec`` prints the reference CLI's JSON for the
same flags. The flags whose subsystems are not ported exit naming their
ROADMAP item.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models.model import init_model as jax_init_model  # noqa: E402
from repro.serving import quantize as jq  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import serving_params  # noqa: E402

torch.set_num_threads(2)

FLAGS = ["--batch", "3", "--prompt-len", "9", "--gen", "6", "--seed", "2"]


@pytest.fixture(scope="module", params=["llama3.2-1b", "qwen2-vl-72b"])
def models(request):
    arch = request.param
    jcfg = jax_get_config(arch, reduced=True).replace(dtype="float32")
    tcfg = get_config(arch, reduced=True).replace(dtype="float32")
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.device_get(jp), tcfg, device="cpu")


def _reference_run_static(monkeypatch, jcfg, jparams, prompts):
    """The reference CLI's run_static over ``prompts`` (its jax.random
    draw replaced for this call)."""
    args = jax_serve.build_parser().parse_args(FLAGS)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(prompts))
        return np.asarray(jax_serve.run_static(args, jcfg, jparams))


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_run_static_matches_reference(models, monkeypatch, quantize):
    jcfg, jp, tcfg, tp = models
    args = serve.build_parser().parse_args(FLAGS + ["--device", "cpu"])
    prompts = serve.static_prompts(args, tcfg.vocab)
    assert prompts.shape == (3, 9) and prompts.dtype == np.int32
    np.testing.assert_array_equal(prompts, serve.static_prompts(args, tcfg.vocab))
    if quantize:
        jparams, tparams = jq.quantize_tree(jp), serving_params(tp, tcfg, torch.device("cpu"),
                                                                quantize="int8")
    else:
        jparams, tparams = jp, tp
    got = serve.run_static(args, tcfg, tparams, prompts)
    ref = _reference_run_static(monkeypatch, jcfg, jparams, prompts)
    assert got.shape == (3, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    # each row is the batch-1 static path's greedy decode of its prompt
    for b, prompt in enumerate(prompts):
        np.testing.assert_array_equal(got[b], serve.static_greedy_reference(
            tcfg, tparams, prompt, 6, prompts.shape[1] + 6, device="cpu"))
    if quantize:
        serve.verify_static_int8(args, tcfg, tparams, prompts, got)
        dq = serve.run_static(args, tcfg, jq_to_port(jq.dequantize_tree(jparams), tcfg),
                              prompts, quiet=True)
        np.testing.assert_array_equal(got, dq)


def jq_to_port(tree, tcfg):
    return params_from_numpy(jax.device_get(tree), tcfg, device="cpu")


def test_static_int8_verify_catches_a_divergence(models, monkeypatch):
    """fp32: the int8 tokens must be the dequantized static path's; a
    token changed in one sequence fails ``--verify``."""
    _, _, tcfg, tp = models
    args = serve.build_parser().parse_args(FLAGS + ["--device", "cpu"])
    prompts = serve.static_prompts(args, tcfg.vocab)
    q = serving_params(tp, tcfg, torch.device("cpu"), quantize="int8")
    got = serve.run_static(args, tcfg, q, prompts, quiet=True)
    got[1, 3] = (got[1, 3] + 1) % tcfg.vocab
    with pytest.raises(SystemExit, match="1/3 sequences"):
        serve.verify_static_int8(args, tcfg, q, prompts, got)


@pytest.mark.parametrize("extra", [[], ["--quantize", "int8", "--verify"]],
                         ids=["plain", "int8-verify"])
def test_cli_static_mode_on_cpu(capsys, extra):
    """The reduced configs compute in bf16: the int8 --verify holds every
    token within the ladder of the dequantized static path."""
    serve.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu"] + FLAGS + extra)
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode:" in out
    if extra:
        assert "weights:" in out
        assert "verify: every token of all 3 sequences lies within the bfloat16 ladder" in out


@pytest.mark.parametrize("flags", [
    [], ["--paged", "--stream", "--scheduler", "slo", "--slots", "3"],
    ["--batch", "2", "--quantize", "int8", "--gen", "9"],
    ["--paged", "--stream", "--streaming-window", "4", "--cold-kv", "int8",
     "--pages-per-seq", "8", "--prefix-cache", "--chunked-prefill", "--request-timeout", "30"],
], ids=["default", "slo", "static-int8", "streaming"])
def test_dump_spec_is_the_reference_json(capsys, flags):
    serve.main(["--arch", "qwen2-vl-72b", "--reduced", "--dump-spec"] + flags)
    port = capsys.readouterr().out
    jax_serve.main(["--arch", "qwen2-vl-72b", "--reduced", "--dump-spec"] + flags)
    assert port == capsys.readouterr().out
    assert json.loads(port)["model"]["arch"] == "qwen2-vl-72b"


@pytest.mark.parametrize("flags, match", [
    (["--serve-rank", "8"], "item 9"),
    (["--paged", "--stream", "--speculative-rank", "8"], "item 6"),
    (["--paged", "--stream", "--disaggregate"], "item 8"),
    (["--paged", "--stream", "--tp", "2"], "item 8"),
    (["--verify"], "needs --paged --stream or --quantize int8"),
    (["--paged"], "go together"),
    (["--streaming-window", "2"], "needs --paged --stream"),
], ids=["serve-rank", "speculative", "disaggregate", "tp", "static-verify", "paged-alone",
        "static-streaming"])
def test_cli_refusals(flags, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu"] + flags)


def test_cli_serves_a_checkpoint(tmp_path, capsys):
    """``--ckpt-dir`` serves the newest checkpoint's params (the flags give
    the geometry); a missing directory exits with its message."""
    from repro_torch.api import CheckpointSpec, ModelSpec, RunSpec, Trainer, TrainSpec

    Trainer(RunSpec(model=ModelSpec("llama3.2-1b", reduced=True),
                    train=TrainSpec(steps=2, batch=2, seq=16),
                    checkpoint=CheckpointSpec(directory=str(tmp_path), every=2)),
            device="cpu").fit()
    serve.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--ckpt-dir",
                str(tmp_path), "--paged", "--stream", "--requests", "2", "--gen", "4",
                "--verify"])
    out = capsys.readouterr().out
    assert f"loaded checkpoint step 2 from {tmp_path}" in out
    assert "verify: all 2 requests match" in out
    with pytest.raises(SystemExit, match="no checkpoints"):
        serve.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--ckpt-dir",
                    str(tmp_path / "missing")])
