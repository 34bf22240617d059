"""The premise of the categorical kernel's bfloat16 Gumbel table
(``csrc/threefry.cu``): JAX's bfloat16 Gumbel is a function of the top 7 of
a value's 8 random bits, so 128 values cover it.  For a few keys, in both
threefry modes, ``jax.random.gumbel(key, (65536,), jnp.bfloat16)`` is set
beside the same key's 8-bit words, ``jax.random.bits(key, (65536,),
jnp.uint8)``: the Gumbel takes at most 128 values, bytes ``b`` and ``b ^ 1``
give the same one, and the port's plain bfloat16 Gumbel
(``kernels.ref._gumbel_bf16``, the formula ``categorical_ref`` draws with)
equals JAX's for every one of the 256 bytes, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import _gumbel_bf16

N = 65536


@pytest.mark.parametrize("partitionable", [True, False], ids=["partitionable", "original"])
@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_jax_bf16_gumbel_is_a_table_of_the_top_7_bits(seed, partitionable):
    with jax.threefry_partitionable(partitionable):
        key = jax.random.PRNGKey(seed)
        g = np.asarray(jax.random.gumbel(key, (N,), jnp.bfloat16)).view(np.uint16)
        bits = np.asarray(jax.random.bits(key, (N,), jnp.uint8)).astype(np.int64)
    assert len(np.unique(g)) <= 128
    table = np.full(256, -1, np.int64)
    for b in range(256):
        seen = np.unique(g[bits == b])
        assert len(seen) == 1, f"byte {b}: {len(seen)} Gumbel values"  # every byte drawn, one value each
        table[b] = seen[0]
    np.testing.assert_array_equal(table[0::2], table[1::2])  # b and b ^ 1 alike: bits >> 1 alone
    port = _gumbel_bf16(torch.arange(256, dtype=torch.int32)).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(port.astype(np.int64), table)
