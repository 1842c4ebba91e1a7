"""Counter-based PRNG: ``jax.random``'s threefry2x32, bit for bit.

Every stochastic draw of the reference goes through ``jax.random`` with
the ``threefry2x32`` implementation in its partitionable mode
(``jax_threefry_partitionable=True``, the default of the jax the
reference runs on). A sampled or quantized tree of the port matches the
reference only if it draws the very same integers, so this module
re-implements that generator in plain torch:

- a key is an int64 tensor ``[2]`` holding two uint32 words; a batch
  of keys is ``[..., 2]``, and :func:`fold_in` and :func:`uniform` take
  one (``jax.vmap`` of them over the keys) in one hash call, so a draw
  per feature or per node costs the ops of one draw, and a key may come
  from device values (no host read);
- :func:`PRNGKey` takes the seed as a 32-bit integer, ``[0, seed mod
  2^32]``, as jax does with ``jax_enable_x64`` off (the reference's
  setting; with x64 on jax would put ``seed >> 32`` in the first word);
- :func:`fold_in` hashes the pair ``(0, data)`` under the key
  (``threefry_fold_in``: ``threefry_2x32(key, threefry_seed(data))``);
- :func:`split` hashes the 64-bit index of each new key, split into
  its hi and lo words, and keeps both output words as the key
  (``_threefry_split_foldlike``);
- :func:`random_bits32` hashes the 64-bit flat index of every element,
  split into its hi and lo words, and xors the two output words
  (``_threefry_random_bits_partitionable``);
- :func:`uniform` keeps the top 23 bits as the mantissa of a float in
  [1, 2) and subtracts 1 (``jax.random._uniform``);

uint32 words are held in int64 tensors and masked with ``0xFFFFFFFF``
after every add and shift: torch's uint32 support is partial and an
int32 right shift is arithmetic. Everything runs on the device of the
key; nothing is global.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

IntOrTensor = Union[int, torch.Tensor]


def PRNGKey(seed: int, device: Union[str, torch.device] = "cpu"
            ) -> torch.Tensor:
    """The key of an integer seed: int64 ``[2]`` = ``[0, seed mod 2^32]``
    (``jax.random.PRNGKey`` with x64 off)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds) of the count words ``(x0, x1)``
    under ``key`` (reference: ``_threefry2x32_lowering``). ``x0`` and
    ``x1`` are int64 tensors of uint32 words; ``key`` is one key ``[2]``
    or keys ``[..., 2]`` whose leading shape broadcasts with the words'.
    Returns the two output words in new int64 tensors of the broadcast
    shape."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, (k0 ^ k1) ^ _KS_PARITY)
    x0 = (x0 + k0).bitwise_and_(_M32)
    x1 = (x1 + k1).bitwise_and_(_M32)
    if x0.shape != x1.shape:
        # the in-place rounds below need both words at the full shape
        x0, x1 = (t.contiguous() for t in torch.broadcast_tensors(x0, x1))
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            hi = x1 << r
            x1.bitwise_right_shift_(32 - r).bitwise_or_(hi).bitwise_and_(
                _M32)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_M32)
    return x0, x1


def fold_in(key: torch.Tensor, data: IntOrTensor) -> torch.Tensor:
    """A new key from ``key`` and a 32-bit integer (``jax.random.fold_in``:
    the count ``[0, data]`` split into halves ``x0 = [0]``,
    ``x1 = [data]``). ``key`` may be keys ``[..., 2]`` and ``data`` an
    integer tensor that broadcasts with ``key[..., 0]``: each key is
    folded with its element, giving keys of the broadcast shape plus
    ``[2]`` (``fold_in(k, d)`` folds one key with each of ``d``'s
    values)."""
    if isinstance(data, torch.Tensor):
        d = data.to(device=key.device, dtype=torch.int64) & _M32
    else:
        if not 0 <= int(data) <= _M32:
            raise ValueError("fold_in data %d is not a uint32" % int(data))
        # a fill: a copy from the host would wait for the card
        d = torch.full((), int(data), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys from ``key``, int64 ``[num, 2]``
    (``jax.random.split`` in partitionable mode: key ``i`` is the hash of
    the count ``(i >> 32, i & 0xFFFFFFFF)``)."""
    counts = torch.arange(int(num), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key, counts >> 32, counts & _M32)
    return torch.stack([y0, y1], dim=1)


def _shape(shape: Union[int, Sequence[int]]) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def random_bits32(key: torch.Tensor, shape: Union[int, Sequence[int]]
                  ) -> torch.Tensor:
    """int64 tensor of uint32 random words of ``shape`` (partitionable
    threefry: the counter of element ``i`` of the flat array is the
    64-bit ``i`` as (hi, lo) words; the bits are ``out0 ^ out1``). Keys
    ``[..., 2]`` give words of ``key.shape[:-1] + shape``."""
    shape = _shape(shape)
    n = 1
    for s in shape:
        n *= s
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    hi = counts >> 32
    counts.bitwise_and_(_M32)
    b0, b1 = threefry2x32(key[..., None, :], hi, counts)
    return b0.bitwise_xor_(b1).reshape(tuple(key.shape[:-1]) + shape)


def uniform(key: torch.Tensor, shape: Union[int, Sequence[int]]
            ) -> torch.Tensor:
    """float32 draws in [0, 1) of ``shape`` (``jax.random.uniform`` for
    float32: ``bits >> 9 | 0x3F800000`` read as a float, minus 1). Keys
    ``[..., 2]`` give draws of ``key.shape[:-1] + shape``, one
    ``uniform(k, shape)`` per key."""
    return _unit_float(random_bits32(key, shape))


def _unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (in int64) -> float32 in [0, 1): the top 23 bits as
    the mantissa of a float in [1, 2), minus 1."""
    bits.bitwise_right_shift_(9).bitwise_or_(0x3F800000)
    return bits.to(torch.int32).view(torch.float32) - 1.0
