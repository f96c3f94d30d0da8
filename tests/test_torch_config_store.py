"""Port vs reference: model configs and the npz checkpoint layout.

Every ``ModelConfig`` field of the port's jax-free copy equals the
reference's, for all arch ids at full size and reduced; an npz written
by either package's ``save_pytree`` reads back bit-exactly in the other,
and the weight bridge maps npz keys one-to-one onto the port's
parameter names."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.store import load_pytree as jax_load_pytree  # noqa: E402
from repro.checkpoint.store import save_pytree as jax_save_pytree  # noqa: E402
from repro.config import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.models.model import init_model as jax_init_model  # noqa: E402
from repro_torch.bridge import as_module, params_from_numpy  # noqa: E402
from repro_torch.checkpoint.store import flatten, load_pytree, save_pytree  # noqa: E402
from repro_torch.config import ARCH_IDS, get_config  # noqa: E402

torch.set_num_threads(2)


def test_arch_ids_match():
    assert list(ARCH_IDS) == list(JAX_ARCH_IDS)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_model_config_fields_equal(arch, reduced):
    ref = dataclasses.asdict(jax_get_config(arch, reduced=reduced))
    port = dataclasses.asdict(get_config(arch, reduced=reduced))
    assert port == ref


def _mixed_tree():
    rng = np.random.default_rng(0)
    return {
        "a": {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "ids": rng.integers(0, 9, size=(5,)).astype(np.int32)},
        "seq": [rng.standard_normal((2,)).astype(np.float32),
                (np.arange(3, dtype=np.int64), np.float32(1.5) * np.ones((1,), np.float32))],
    }


def _assert_trees_bitwise_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def test_npz_round_trip_is_bit_exact(tmp_path):
    """reference save -> port load -> port save -> reference load."""
    tree = _mixed_tree()
    jax_save_pytree(tree, str(tmp_path / "ref.npz"))
    loaded = load_pytree(str(tmp_path / "ref.npz"))
    assert isinstance(loaded["seq"], list) and isinstance(loaded["seq"][1], tuple)
    save_pytree(loaded, str(tmp_path / "port.npz"))
    back = jax_load_pytree(str(tmp_path / "port.npz"))
    _assert_trees_bitwise_equal(tree, back)


def test_bridge_keys_map_onto_module_names(tmp_path):
    """The reference's parameters, through its npz, become the port's
    parameter tree; the nn.Module view names every parameter by its npz
    key with '.' for '/'."""
    cfg = jax_get_config("llama3.2-1b", reduced=True)
    params = jax.device_get(jax_init_model(jax.random.PRNGKey(0), cfg))
    jax_save_pytree(params, str(tmp_path / "p.npz"))
    port = params_from_numpy(str(tmp_path / "p.npz"), get_config("llama3.2-1b", reduced=True),
                             device="cpu")
    flat_ref = flatten(params)
    names = dict(as_module(port).named_parameters())
    assert set(names) == {k.replace("/", ".") for k in flat_ref}
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(names[k.replace("/", ".")].detach().numpy(),
                                      np.asarray(v))
    # the tree view shares storage with the module
    tree = as_module(port).tree()
    assert tree["layers"]["mlp"]["up"]["U"].shape == flat_ref["layers/mlp/up/U"].shape


def test_bridge_rejects_a_mismatched_config():
    cfg = jax_get_config("llama3.2-1b", reduced=True)
    params = jax.device_get(jax_init_model(jax.random.PRNGKey(0), cfg))
    with pytest.raises(ValueError):
        params_from_numpy(params, get_config("smollm2-135m", reduced=True), device="cpu")
