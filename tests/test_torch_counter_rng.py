"""The counter generator of the Gumbel draw (``kde_tpu_torch/utils/
random.py``, the twin of ``csrc/counter_rng.cuh``) against JAX's own.

``threefry2x32`` is held word for word to ``jax._src.prng.threefry_2x32``
(the generator behind ``kde_tpu/ops/gibbs.py::_select_label_gumbel``) on a
grid of keys and counters and at Random123's known answer, and
``fold_in`` and the selection key to ``jax.random.fold_in``.  The word to
float maps stay in (0, 1) after the clamp, at the extreme words too."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src import prng  # noqa: E402
from kde_tpu_torch.utils import random as rnd  # noqa: E402

EDGE = (0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x9E3779B9, 0xFFFFFFFE, 0xFFFFFFFF)


def _jax_block(k0, k1, x0, x1):
    out = prng.threefry_2x32(jnp.array([k0, k1], dtype=jnp.uint32),
                             jnp.array([x0, x1], dtype=jnp.uint32))
    return tuple(int(v) for v in np.asarray(out))


def test_known_answer():
    """Random123's known answer for threefry2x32_20 (key and counter from
    the digits of pi), as JAX gives it."""
    want = (0xC4923A9C, 0x483DF7A0)
    args = (0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3)
    assert rnd.threefry2x32(*args) == want
    assert _jax_block(*args) == want
    got = rnd.threefry2x32(*(torch.tensor([a]) for a in args))
    assert tuple(int(g) for g in got) == want


def test_threefry_equals_jax_on_a_grid():
    """Every (key, counter) pair of edge words and random words, as int64
    tensors on the CPU, against JAX's threefry_2x32 of each pair."""
    rng = np.random.default_rng(0)
    words = np.array(EDGE + tuple(rng.integers(0, 1 << 32, 8)),
                     dtype=np.int64)
    k0, k1, x0, x1 = (torch.as_tensor(a.ravel()) for a in np.meshgrid(
        words[::2], words[1::2], words[::3], words[1::3], indexing="ij"))
    y0, y1 = rnd.threefry2x32(k0, k1, x0, x1)
    keys = jnp.stack([jnp.asarray(k0.numpy(), jnp.uint32),
                      jnp.asarray(k1.numpy(), jnp.uint32)], axis=1)
    cnts = jnp.stack([jnp.asarray(x0.numpy(), jnp.uint32),
                      jnp.asarray(x1.numpy(), jnp.uint32)], axis=1)
    want = np.asarray(jax.vmap(prng.threefry_2x32)(keys, cnts)).astype(
        np.int64)
    np.testing.assert_array_equal(y0.numpy(), want[:, 0])
    np.testing.assert_array_equal(y1.numpy(), want[:, 1])
    assert int(y0.min()) >= 0 and int(y0.max()) < 1 << 32


def test_fold_in_and_selection_key_equal_jax():
    """fold_in(k, x) is jax.random.fold_in's key data, and the selection
    key fold_in(fold_in(seed, chain), sel) folds twice as JAX would."""
    for seed in ((0, 0), (1, 2), (0xDEADBEEF, 0xFFFFFFFF)):
        key = jax.random.wrap_key_data(jnp.array(seed, dtype=jnp.uint32),
                                       impl="threefry2x32")
        for chain, sel in ((0, 0), (5, 13), (1 << 31, 0xFFFFFFFF)):
            want = np.asarray(jax.random.key_data(jax.random.fold_in(
                jax.random.fold_in(key, chain), sel)))
            got = rnd.fold_in(*rnd.fold_in(*seed, chain), sel)
            assert got == tuple(int(v) for v in want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_word_to_float_is_in_the_open_unit_interval(dtype):
    """The uniforms lie in (0, 1) after the clamp to [tiny, 1 - eps]: the
    all-zero words map to tiny, the all-one words to 1 - eps; and on a grid
    of seeds, chains and selections the draw is a pure function of them
    (the same arguments in another batch give the same bits)."""
    fi = torch.finfo(dtype)
    seeds = torch.tensor([[3, 4], [0xFFFFFFFF, 7]])
    chains, sels = torch.arange(300, 340), torch.tensor([0, 9, 1 << 30])
    u = rnd.counter_uniform(seeds, chains, sels, 257, dtype)
    assert u.shape == (2, 40, 3, 257) and u.dtype == dtype
    assert float(u.min()) >= fi.tiny and float(u.max()) <= 1.0 - fi.eps
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    again = rnd.counter_uniform(seeds[1:], chains[7:9], sels[1:2], 257,
                                dtype)
    assert torch.equal(again, u[1:, 7:9, 1:2])
    # the extreme words through the same map
    for words, want in (((0, 0), fi.tiny), ((0xFFFFFFFF,) * 2, 1 - fi.eps)):
        y0, y1 = (torch.tensor([w]) for w in words)
        if dtype == torch.float32:
            v = ((y0 >> 9) | 0x3F800000).to(torch.int32).view(dtype) - 1.0
        else:
            v = ((y0 << 20) | (y1 >> 12) | 0x3FF0000000000000).view(
                dtype) - 1.0
        assert float(v.clamp(fi.tiny, 1 - fi.eps)) == want


def test_counter_seed_takes_two_words():
    g = torch.Generator().manual_seed(5)
    s = rnd.counter_seed(g)
    assert s.shape == (2,) and s.dtype == torch.int64
    assert 0 <= int(s.min()) and int(s.max()) < 1 << 32
    assert torch.equal(s, rnd.counter_seed(torch.Generator().manual_seed(5)))
