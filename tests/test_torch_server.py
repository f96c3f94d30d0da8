"""Port vs reference: the Server facade (``api/server.py``) and the serving
specs (``api/specs.py``: ``ServeSpec``, ``StreamingSpec``, ``ShardingSpec``,
``RankScheduleSpec`` inside ``RunSpec``).

Specs: the port's JSON of a spec is the reference's text, and each
package reads the other's back to an equal spec; a sidecar without a
``serve`` entry (what the port wrote before it had one) still loads.
Server: ``from_checkpoint`` with zero flags on a checkpoint that each
package's ``Trainer`` wrote serves the spec it embeds and gives the
reference ``Server``'s tokens and its own static path's; ``Server(spec,
params)`` on bridged weights gives the reference's tokens under the SLO
scheduler; ``stream``, abandoned-stream recovery, rid assignment and
duplicate refusal follow the reference's facade tests
(``tests/test_api_facades.py``); every refusal names its ROADMAP item.

Both packages' ``ModelSpec.config`` are pinned to fp32 compute in this
file, so token comparisons across packages are about the algorithm (in
bf16 the port's spectral h stays fp32 where the reference's rounds it).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.models.model import init_model as jax_init_model  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.launch.serve import static_greedy_reference  # noqa: E402
from repro_torch.serving import Request  # noqa: E402

torch.set_num_threads(2)

ARCH = "llama3.2-1b"


@pytest.fixture(scope="module", autouse=True)
def fp32_configs():
    mp = pytest.MonkeyPatch()
    for cls in (api.ModelSpec, japi.ModelSpec):
        base = cls.config
        mp.setattr(cls, "config", lambda self, _b=base: _b(self).replace(dtype="float32"))
    yield
    mp.undo()


def _spec(pkg, ckpt_dir=None, steps=2, **serve):
    kw = dict(page_size=8, num_pages=32, slots=2, pages_per_seq=6, gen=5)
    kw.update(serve)
    return pkg.RunSpec(
        model=pkg.ModelSpec(ARCH, reduced=True),
        train=pkg.TrainSpec(steps=steps, batch=2, seq=32, lr=3e-3),
        checkpoint=pkg.CheckpointSpec(directory=None if ckpt_dir is None else str(ckpt_dir),
                                      every=2),
        serve=pkg.ServeSpec(**kw))


def _prompts(vocab, lens=(5, 9)):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in lens]


# ------------------------------------------------------------------ specs --

SPEC_CASES = {
    "default": {},
    "serve": {"serve": {"slots": 3, "prefix_cache": True, "chunked_prefill": True,
                        "request_timeout": 40, "quantize": "int8", "batch": 2,
                        "scheduler": "slo", "shed": False, "tenant": "acme", "priority": 1,
                        "default_deadline": 30}},
    "streaming": {"serve": {"pages_per_seq": 8, "streaming": {
        "sink_pages": 1, "window_pages": 4, "cold_kv": "int8"}}},
    "static": {"serve": {"mode": "static", "batch": 3, "prompt_len": 12, "gen": 7}},
    "unported_fields": {"serve": {"speculative_rank": "4,8", "draft_tokens": 3,
                                  "kv_transfer": "int8"}},
    "training": {"train": {"steps": 9, "lr": 0.002, "microbatches": 2},
                 "precision": {"mode": "mixed"}, "sharding": {"data": 1, "model": 1},
                 "checkpoint": {"directory": "/run", "every": 3}},
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_json_round_trips_both_ways(case):
    data = json.loads(japi.RunSpec().to_json())
    for section, body in SPEC_CASES[case].items():
        if "streaming" in body:
            data[section]["streaming"].update(body["streaming"])
            body = {k: v for k, v in body.items() if k != "streaming"}
        data[section].update(body)
    ref = japi.RunSpec.from_dict(data)
    port = api.RunSpec.from_dict(data)
    assert port.to_json() == ref.to_json()
    assert port.to_json(indent=2) == ref.to_json(indent=2)
    assert api.RunSpec.from_json(ref.to_json()) == port
    assert japi.RunSpec.from_json(port.to_json()) == ref
    assert api.RunSpec.from_json(port.to_json()) == port


def test_sidecar_without_serve_still_loads(tmp_path):
    """What the port wrote before it had ``serve``, ``rank`` and
    ``sharding``: the sub-specs come back at their defaults, and a Server
    serves it with the default geometry."""
    full = _spec(api).to_dict()
    old = {k: v for k, v in full.items() if k not in ("serve", "rank", "sharding")}
    spec = api.RunSpec.from_dict(old)
    assert spec.serve == api.ServeSpec() and spec.sharding == api.ShardingSpec()
    mgr = CheckpointManager(str(tmp_path), run_spec=old)
    from repro_torch.models.model import init_model

    mgr.save(3, {"params": init_model(spec.model.config(), device="cpu")}, block=True)
    server = api.Server.from_checkpoint(str(tmp_path), device="cpu")
    assert server.checkpoint_step == 3 and server.spec.serve == api.ServeSpec()
    rid = server.submit(_prompts(server.cfg.vocab, (4,))[0], max_new_tokens=3)
    assert len(server.run()[rid]) == 3


# ------------------------------------------------------------ checkpoints --

@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{writer: checkpoint directory}: two steps of each package's Trainer."""
    root = tmp_path_factory.mktemp("server_ckpt")
    japi.Trainer(_spec(japi, root / "jax")).fit()
    api.Trainer(_spec(api, root / "port"), device="cpu").fit()
    return {"jax": str(root / "jax"), "port": str(root / "port")}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_from_checkpoint_zero_flags_matches_reference_server(checkpoints, writer):
    ckpt = checkpoints[writer]
    server = api.Server.from_checkpoint(ckpt, device="cpu")
    jserver = japi.Server.from_checkpoint(ckpt)
    assert server.spec.to_json() == jserver.spec.to_json()
    assert server.spec == _spec(api, ckpt)
    assert server.checkpoint_step == jserver.checkpoint_step == 2
    prompts = _prompts(server.cfg.vocab)
    rids = [server.submit(p) for p in prompts]
    jrids = [jserver.submit(p) for p in prompts]
    out, jout = server.run(), jserver.run()
    max_seq = server.spec.serve.paged_config().max_seq
    for rid, jrid, prompt in zip(rids, jrids, prompts):
        assert len(out[rid]) == server.spec.serve.gen          # gen from the spec
        np.testing.assert_array_equal(out[rid], jout[jrid])
        np.testing.assert_array_equal(
            out[rid], static_greedy_reference(server.cfg, server.params, prompt,
                                              server.spec.serve.gen, max_seq, device="cpu"))
        assert server.last_statuses[rid] == "finished"


def test_from_checkpoint_overrides_and_rank(checkpoints):
    """Overrides apply on top of the embedded spec; ``serve.rank`` at the
    checkpoint's own rank loads, another raises."""
    server = api.Server.from_checkpoint(checkpoints["port"], device="cpu",
                                        **{"serve.scheduler": "slo", "serve.gen": 3})
    assert server.spec.serve.scheduler == "slo" and server.spec.serve.gen == 3
    cfg = _spec(api).model.config()
    server = api.Server.from_checkpoint(checkpoints["port"], device="cpu",
                                        **{"serve.rank": cfg.sct.rank})
    assert server.spec.serve.rank == cfg.sct.rank
    with pytest.raises(NotImplementedError, match="item 9"):
        api.Server.from_checkpoint(checkpoints["port"], device="cpu",
                                   **{"serve.rank": cfg.sct.rank // 2})


def test_params_from_checkpoint_loads_on_the_card_unless_told(checkpoints, monkeypatch):
    """No device means the card, as everywhere in the port: without one it
    raises; ``device="cpu"`` loads the trained params on the host."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.serving.engine import params_from_checkpoint

    step, params = params_from_checkpoint(checkpoints["port"], device="cpu")
    assert step == 2 and all(t.device.type == "cpu" for t in tree_leaves(params))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_checkpoint(checkpoints["port"])


def test_server_matches_reference_server_on_bridged_weights():
    """Random reference weights through the bridge, the SLO scheduler
    with tenants and priorities: the same tokens as the reference's
    Server, every request finished, nothing shed."""
    spec, jspec = (_spec(pkg, scheduler="slo", default_deadline=500) for pkg in (api, japi))
    jp = jax_init_model(jax.random.PRNGKey(1), jspec.model.config())
    server = api.Server(spec, params_from_numpy(jax.device_get(jp), spec.model.config(),
                                                device="cpu"), device="cpu")
    jserver = japi.Server(jspec, jp)
    for i, p in enumerate(_prompts(server.cfg.vocab, (3, 7, 5, 9, 4))):
        for s in (server, jserver):
            s.submit(p, tenant=f"t{i % 2}", priority=i % 3)
    out, jout = server.run(), jserver.run()
    assert sorted(out) == sorted(jout) == list(range(5))
    for rid in out:
        np.testing.assert_array_equal(out[rid], jout[rid], err_msg=f"request {rid}")
    st = server.stats()
    assert st["shed"] == 0 and st["requests"] == 5
    assert {k: v for k, v in st.items() if k.startswith("tenant_")} == \
        {k: v for k, v in jserver.stats().items() if k.startswith("tenant_")}


def test_shed_request_never_holds_a_slot():
    spec = _spec(api, scheduler="slo")
    server = api.Server(spec, device="cpu")
    p = _prompts(server.cfg.vocab, (4,))[0]
    ok = server.submit(p, max_new_tokens=4, deadline=100)
    doomed = server.submit(p, max_new_tokens=8, deadline=3)
    out = server.run()
    assert server.last_statuses == {ok: "finished", doomed: "shed"}
    assert len(out[doomed]) == 0 and server.stats()["shed"] == 1


# ----------------------------------------------------------- the facade --

@pytest.fixture
def server(checkpoints):
    return api.Server.from_checkpoint(checkpoints["port"], device="cpu")


def test_server_stream_yields_completions(server):
    rids = {server.submit(p, max_new_tokens=4)
            for p in _prompts(server.cfg.vocab, lens=(4, 6, 8))}
    events = list(server.stream())
    assert {rid for rid, _, _ in events} == rids
    assert all(status == "finished" and len(tokens) == 4 for _, tokens, status in events)
    with pytest.raises(ValueError, match="submit"):
        server.run()
    assert server.submit([1, 2, 3], rid=7) == 7
    assert server.submit([1, 2, 3]) == 8
    with pytest.raises(ValueError, match="already queued"):
        server.submit([1, 2, 3], rid=7)


def test_server_stream_abandoned_midway_recovers(server):
    rids = {server.submit(p, max_new_tokens=3)
            for p in _prompts(server.cfg.vocab, lens=(4, 5, 6))}
    gen = server.stream()
    first_rid, _, _ = next(gen)
    with pytest.raises(ValueError, match="already queued"):
        server.submit([1, 2, 3], rid=min(rids - {first_rid}))
    gen.close()
    rest = list(server.stream())
    assert {rid for rid, _, _ in rest} == rids - {first_rid}
    assert all(server.last_statuses[rid] == "finished" for rid in rids - {first_rid})
    with pytest.raises(ValueError, match="submit"):
        server.run()


def test_server_stream_future_arrivals_and_unconsumed_generators(server):
    p_now, p_later = _prompts(server.cfg.vocab, lens=(4, 5))
    r_now = server.submit(p_now, max_new_tokens=3)
    r_later = server.submit(p_later, max_new_tokens=3, arrival=40)
    gen = server.stream()
    assert next(gen)[0] == r_now
    gen.close()
    assert set(server.run()) == {r_later}
    r3 = server.submit(p_now, max_new_tokens=2)
    server.stream()                                # discarded unconsumed
    assert set(server.run()) == {r3}


def test_server_auto_rid_dodges_explicit_trace_rids(server):
    (p,) = _prompts(server.cfg.vocab, lens=(4,))
    server.stream([Request(rid=0, prompt=p, max_new_tokens=2),
                   Request(rid=1, prompt=p, max_new_tokens=2)])
    assert server.submit(p, max_new_tokens=2) == 2
    assert set(server.run()) == {0, 1, 2}
    assert not server.engine.has_pending_work


# -------------------------------------------------------------- refusals --

@pytest.mark.parametrize("serve, err, match", [
    ({"mode": "static"}, ValueError, "paged engine"),
    ({"speculative_rank": "8"}, NotImplementedError, "item 6"),
    ({"draft_tokens": 2}, NotImplementedError, "item 6"),
    ({"disaggregate": True}, NotImplementedError, "item 8"),
    ({"kv_transfer": "int8"}, NotImplementedError, "item 8"),
], ids=["static", "speculative", "draft_tokens", "disaggregate", "kv_transfer"])
def test_server_refusals(serve, err, match):
    with pytest.raises(err, match=match):
        api.Server(_spec(api, **serve), device="cpu")


@pytest.mark.parametrize("section, body, match", [
    ("sharding", {"decode_mesh": 2}, "item 8"),
    ("sharding", {"data": 2}, "item 10"),
    ("sharding", {"model": 4}, "item 10"),
    ("rank", {"schedule": "static:8"}, "item 9"),
])
def test_spec_refusals_name_their_item(section, body, match):
    data = api.RunSpec().to_dict()
    data[section].update(body)
    japi.RunSpec.from_dict(data)                   # the reference reads it
    with pytest.raises(NotImplementedError, match=match):
        api.RunSpec.from_dict(data)
    assert api.ShardingSpec().serve_mesh() is None


def test_load_run_spec_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        api.load_run_spec(str(tmp_path / "missing"))
    assert not os.path.exists(tmp_path / "missing")
    JaxCheckpointManager(str(tmp_path / "old")).save(1, {"x": np.zeros((2,), np.float32)},
                                                     block=True)
    with pytest.raises(ValueError, match="embeds no RunSpec"):
        api.load_run_spec(str(tmp_path / "old"))
    with pytest.raises(FileNotFoundError):
        api.Server.from_checkpoint(str(tmp_path / "missing"), device="cpu")


def test_server_needs_a_gpu_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.Server(_spec(api))
    assert dataclasses.is_dataclass(api.ServeSpec())
