"""The port's SHA-256 lanes (lighthouse_tpu_torch.torchhash) on the CPU:
the plain versions of csrc/sha256.cu's two kernels against hashlib and
against the JAX package's device programs.

- sha256_msgs (through engine.sha256_msgs_device) against hashlib at
  the padding edges, and against jaxhash/engine.py's sha256_msgs_device
  (one and two blocks);
- the ladder behind device_build_levels against jaxhash/engine.py's
  device_build_levels at (100, 12) and (257, 40), whole, root_only and
  with min_level, and against the port's host builder (tree_cache._build);
- sha256_ladder at widths that are not powers of two and on zero leaves,
  whose levels are ZERO_HASHES;
- the kernels' generated constants against the tables they come from.

Tolerance: exact equality. The JAX side compiles two ladder buckets (128
and 512 leaves) and the multi-block digest at one and two blocks.
"""

import hashlib
import re

import numpy as np
import pytest

from lighthouse_tpu.jaxhash import engine as jengine
from lighthouse_tpu.ssz import tree_cache as jtc

# the port loads when this file's first test runs, not at collection
torch = K = engine = tc = sb = ZERO_HASHES = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    global torch, K, engine, tc, sb, ZERO_HASHES
    import torch
    from lighthouse_tpu_torch.ssz import sha256_batch as sb
    from lighthouse_tpu_torch.ssz import tree_cache as tc
    from lighthouse_tpu_torch.ssz.core import ZERO_HASHES
    from lighthouse_tpu_torch.torchhash import engine
    from lighthouse_tpu_torch.torchhash import kernels as K

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    engine.set_device("cpu")
    yield
    engine.set_device(None)
    torch.set_num_threads(prev)


def rand_bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("length", [0, 1, 31, 32, 55, 56, 63, 64, 65, 119, 128, 200])
def test_msgs_match_hashlib(length):
    msgs = rand_bytes((5, length), seed=length)
    got = engine.sha256_msgs_device(msgs)
    assert got.shape == (5, 32)
    for i in range(5):
        assert got[i].tobytes() == hashlib.sha256(msgs[i].tobytes()).digest()


@pytest.mark.parametrize("length", [40, 64])
def test_msgs_match_reference_device(length):
    """One and two padded blocks, against the JAX multi-block digest."""
    msgs = rand_bytes((9, length), seed=100 + length)
    assert np.array_equal(engine.sha256_msgs_device(msgs), jengine.sha256_msgs_device(msgs))


@pytest.mark.parametrize("n,depth", [(100, 12), (257, 40)])
def test_ladder_matches_reference_device_build_levels(n, depth):
    """Levels and root bit-identical to the JAX ladder's, whole, root-only
    and with the levels below min_level skipped, and to the port's host
    builder."""
    leaves = rand_bytes((n, 32), seed=n)
    lv, root = engine.device_build_levels(leaves, depth)
    jlv, jroot = jengine.device_build_levels(leaves, depth)
    hlv, hroot = tc._build(leaves, depth)
    assert root == jroot == hroot == jtc._build(leaves, depth)[1]
    assert len(lv) == len(jlv) == len(hlv) == depth
    for a, b, c in zip(lv, jlv, hlv):
        assert a.shape == b.shape == c.shape
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert engine.device_build_levels(leaves, depth, root_only=True) == (None, root)
    assert jengine.device_build_levels(leaves, depth, root_only=True) == (None, root)
    min_level = 3
    skipped, root3 = engine.device_build_levels(leaves, depth, min_level=min_level)
    jskipped, jroot3 = jengine.device_build_levels(leaves, depth, min_level=min_level)
    assert root3 == jroot3 == root
    for d, (a, b) in enumerate(zip(skipped, jskipped)):
        if d < min_level:
            assert a is None and b is None
        else:
            assert np.array_equal(a, b) and np.array_equal(a, lv[d])


def test_depth_below_bucket_refused():
    with pytest.raises(ValueError, match="below padded bucket depth"):
        engine.device_build_levels(rand_bytes((100, 32), 1), 6)


@pytest.mark.parametrize("n", [1, 2, 3, 63, 64, 65, 100])
def test_ladder_widths_pair_odd_tails_with_zero_hashes(n):
    """A ladder over n nodes has ceil(log2 n) levels, each the zero-padded
    tree's prefix: the host builder's levels."""
    leaves = rand_bytes((n, 32), seed=7 * n)
    levels = K.sha256_ladder(torch.from_numpy(engine.words_from_leaves(leaves)))
    assert [lvl.shape[0] for lvl in levels] == K.ladder_widths(n)
    assert len(levels) == (n - 1).bit_length()
    want, _root = tc._build(leaves, max(1, len(levels)))
    for got, w in zip(levels, want):
        assert got.dtype == torch.int32
        assert np.array_equal(engine.leaves_from_words(got.numpy()), w)


def test_ladder_of_zero_leaves_is_zero_hashes():
    levels = K.sha256_ladder(torch.zeros((64, 8), dtype=torch.int32))
    assert [engine.leaves_from_words(lvl.numpy())[0].tobytes() for lvl in levels] == ZERO_HASHES[1:7]


def test_wrappers_route_by_device():
    """CPU tensors take the plain versions; a device with neither a kernel
    nor a plain version is refused."""
    words = torch.from_numpy(engine.words_from_leaves(rand_bytes((4, 32), 3)))
    before = K.sha256_ladder.launches
    assert len(K.sha256_ladder(words)) == 2
    assert K.sha256_ladder.launches == before           # no kernel launched on the CPU
    with pytest.raises(ValueError, match="no kernel or plain version"):
        K.sha256_ladder(words.to("meta"))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        K.sha256_msgs(torch.zeros((1, 16), dtype=torch.int32, device="meta"))


def test_words_round_trip_and_match_sha256_batch():
    leaves = rand_bytes((33, 32), 5)
    words = engine.words_from_leaves(leaves)
    assert words.dtype == np.int32
    assert np.array_equal(words.view(np.uint32), sb.words_from_bytes(leaves))
    assert np.array_equal(engine.leaves_from_words(words), leaves)


def test_consts_header_matches_tables():
    """hash_consts.cuh: K, H0, the pad block's schedule added to K, and the
    zero-subtree roots, from the tables the plain versions use."""
    text = K.consts_header()

    def table(name):
        body = re.search(rf"{name}\[[^=]*= \{{(.*?)\}};", text, re.S).group(1)
        return [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", body)]

    assert table("SHA_K") == list(sb.SHA256_K)
    assert table("SHA_H0") == list(sb.SHA256_H0)
    # the pad block's compression, restated with its schedule from PAD_KW
    state = list(sb.SHA256_H0)
    v = tuple(state)
    kw = table("PAD_KW")
    for t in range(64):
        a, b, c, d, e, f, g, h = sb.round_step(v, kw[t], 0)
        v = (a & K.MASK32, b, c, d, e & K.MASK32, f, g, h)
    padded = [(x + s) & K.MASK32 for x, s in zip(v, state)]
    words = [torch.tensor([x]) for x in state]
    pad = [torch.tensor([x]) for x in sb.PAIR_PAD_WORDS]
    assert padded == [int(x) for x in K.compress_plain(words, pad)]
    zero = table("ZERO_HASH_W")
    assert len(zero) == 64 * 8
    assert all(b"".join(w.to_bytes(4, "big") for w in zero[8 * d:8 * d + 8]) == ZERO_HASHES[d]
               for d in range(64))


def test_port_sha256_batch_is_the_reference_copy():
    from lighthouse_tpu.ssz import sha256_batch as jsb

    assert sb.SHA256_K == jsb.SHA256_K and sb.SHA256_H0 == jsb.SHA256_H0
    assert sb.PAIR_PAD_WORDS == jsb.PAIR_PAD_WORDS
    left, right = rand_bytes((10, 32), 1), rand_bytes((10, 32), 2)
    assert np.array_equal(sb.sha256_pairs(left, right), jsb.sha256_pairs(left, right))
