"""The port's 2-bit codec and K1 (plain version on the CPU) against the
JAX package and a numpy oracle.  Exact equality throughout: codes are
integers.  The CUDA kernel itself is held to the plain version on the
card (marked ``cuda``; skipped without one)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unikmer_tpu.models import count as jax_count
from unikmer_tpu.ops import codec as jax_codec
from unikmer_tpu.ops.pallas_encode import encode_canonical_pallas
from unikmer_tpu_torch.models.count import pack_bases_2bit
from unikmer_tpu_torch.ops import codec
from unikmer_tpu_torch.ops.encode import (
    encode_2bit, encode_2bit_plain, unpack_bases_2bit,
)

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def random_bases(rng, n, p_invalid=0.02):
    b = rng.integers(0, 4, size=n, dtype=np.uint8)
    b[rng.random(n) < p_invalid] = rng.integers(4, 256, dtype=np.uint8)
    return b


def numpy_keyed(bases, k, canonical):
    """Oracle: (keyed u64 [n], valid bool [n]) by direct window sums."""
    n = len(bases)
    keyed = np.full(n, SENT, np.uint64)
    valid = np.zeros(n, bool)
    m = n - k + 1
    if m <= 0:
        return keyed, valid
    codes = np.zeros(m, np.uint64)
    for j in range(k):
        codes = (codes << np.uint64(2)) | (bases[j:j + m] & 3).astype(np.uint64)
    bad = np.concatenate([[0], np.cumsum(bases >= 4)])
    valid[:m] = bad[k:] - bad[:m] == 0
    if canonical:
        codes = jax_codec.canonical_np(codes, k)
    keyed[:m] = np.where(valid[:m], codes, SENT)
    return keyed, valid


def port_keyed(bases, k, canonical):
    p2, vm = pack_bases_2bit(bases)
    keyed, valid = encode_2bit(torch.from_numpy(p2), torch.from_numpy(vm),
                               len(bases), k, canonical)
    return keyed.numpy().view(np.uint64), valid.numpy().astype(bool)


@pytest.mark.parametrize("k", [5, 23, 31, 32])
@pytest.mark.parametrize("canonical", [False, True])
def test_k1_plain_matches_pallas_interpret(k, canonical):
    rng = np.random.default_rng(100 + k)
    bases = random_bases(rng, 3001)
    codes, valid = encode_canonical_pallas(jnp.asarray(bases), k, canonical,
                                           interpret=True)
    codes, valid = np.asarray(codes), np.asarray(valid)
    want = np.where(valid, codes, SENT)
    got_keyed, got_valid = port_keyed(bases, k, canonical)
    np.testing.assert_array_equal(got_valid, valid)
    np.testing.assert_array_equal(got_keyed, want)


@pytest.mark.parametrize("k", range(1, 33))
def test_k1_plain_matches_numpy_every_k(k):
    rng = np.random.default_rng(k)
    for n in (0, 1, k - 1, k, k + 3, 1001, 4099):
        bases = random_bases(rng, n, p_invalid=0.03)
        for canonical in (False, True):
            got = port_keyed(bases, k, canonical)
            want = numpy_keyed(bases, k, canonical)
            np.testing.assert_array_equal(got[1], want[1], err_msg=f"n={n}")
            np.testing.assert_array_equal(got[0], want[0], err_msg=f"n={n}")


@pytest.mark.parametrize("k", [1, 7, 23, 32])
def test_codec_matches_jax(k):
    rng = np.random.default_rng(7 * k)
    bases = random_bases(rng, 997, p_invalid=0.05)
    tb = torch.from_numpy(bases)
    jc = np.asarray(jax_codec.kmer_codes(jnp.asarray(bases), k))
    jv = np.asarray(jax_codec.window_valid(jnp.asarray(bases), k))
    jcc = np.asarray(jax_codec.canonical_code(jnp.asarray(jc), k))
    tc = codec.kmer_codes(tb, k)
    np.testing.assert_array_equal(tc.numpy().view(np.uint64), jc)
    np.testing.assert_array_equal(codec.window_valid(tb, k).numpy(), jv)
    np.testing.assert_array_equal(
        codec.canonical_code(tc, k).numpy().view(np.uint64), jcc)


@pytest.mark.parametrize("k", [1, 2, 16, 31, 32])
def test_revcomp_matches_numpy_twin(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 1 << (2 * k), size=500, dtype=np.uint64)
    got = codec.revcomp_code(torch.from_numpy(codes.view(np.int64)), k)
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  jax_codec.revcomp_np(codes, k))


def test_window_valid_short_inputs():
    for n in range(0, 8):
        v = codec.window_valid(torch.zeros(n, dtype=torch.uint8), 5)
        assert v.tolist() == [i <= n - 5 for i in range(n)]


@pytest.mark.parametrize("n", [0, 1, 3, 8, 13, 4099])
def test_unpack_matches_jax(n):
    rng = np.random.default_rng(n)
    bases = random_bases(rng, n, p_invalid=0.1)
    p2, vm = pack_bases_2bit(bases)
    want = np.asarray(jax_count.unpack_bases_2bit(jnp.asarray(p2),
                                                  jnp.asarray(vm), n))
    got = unpack_bases_2bit(torch.from_numpy(p2), torch.from_numpy(vm), n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_k1_poly_t_real_sentinel():
    # k=32 non-canonical TTTT... has the code 2^64-1 on a VALID window
    bases = np.full(100, 3, np.uint8)
    keyed, valid = port_keyed(bases, 32, False)
    assert valid[:69].all() and not valid[69:].any()
    assert (keyed == SENT).all()


def test_encode_rejects_bad_inputs():
    p2 = torch.zeros(2, dtype=torch.uint8)
    vm = torch.zeros(1, dtype=torch.uint8)
    with pytest.raises(ValueError):
        encode_2bit(p2, vm, 9, 5, True)  # 9 bases need 3 packed bytes
    with pytest.raises(ValueError):
        encode_2bit(p2, vm, 8, 33, True)
    with pytest.raises(ValueError):
        encode_2bit(p2.to(torch.int32), vm, 8, 5, True)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 23, 31, 32])
def test_k1_kernel_matches_plain_on_card(cuda_device, k):
    rng = np.random.default_rng(k)
    # a thread's windows (32) and a block's (4,096), each +- 1
    for n in (1, 7, 31, 32, 33, 4095, 4096, 4097, 8193, 4099, (1 << 20) + 3):
        p2, vm = pack_bases_2bit(random_bases(rng, n))
        p2 = torch.from_numpy(p2).to(cuda_device)
        vm = torch.from_numpy(vm).to(cuda_device)
        for canonical in (False, True):
            got = encode_2bit(p2, vm, n, k, canonical)
            want = encode_2bit_plain(p2, vm, n, k, canonical)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # views 1 byte past a 16-byte boundary are cloned first
    n = 4099
    p2, vm = pack_bases_2bit(random_bases(rng, n))
    bufs = [torch.zeros(len(a) + 1, dtype=torch.uint8, device=cuda_device)
            for a in (p2, vm)]
    p2v, vmv = (b[1:].copy_(torch.from_numpy(a)) for b, a in zip(bufs, (p2, vm)))
    got = encode_2bit(p2v, vmv, n, k, True)
    want = encode_2bit_plain(p2v, vmv, n, k, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------
# K1's kernel walked block by block and thread by thread in numpy
# (csrc/encode.cu; its constants are read from the source)

CSRC = (Path(__file__).resolve().parent.parent / "unikmer_tpu_torch" / "csrc"
        / "encode.cu").read_text()


def cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CSRC).group(1))


THREADS, W = cu_const("kThreads"), cu_const("kW")
BLOCK = THREADS * W  # kBlockWindows
U64 = np.uint64
POISON = U64(0x5A5A5A5A5A5A5A5A)


def rev2_np(x):
    """Reverse the 32 2-bit groups of u64 x (the kernel's rev2)."""
    for shift, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                     (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF),
                     (32, 0x00000000FFFFFFFF)):
        s, mm = U64(shift), U64(m)
        x = ((x >> s) & mm) | ((x & mm) << s)
    return x


def span16(buf, off, vecs):
    """``vecs`` 16-byte words of buf from byte off, zero past its end."""
    out = np.zeros(16 * vecs, np.uint8)
    src = buf[off:off + 16 * vecs]
    out[:len(src)] = src
    return out


def quarter_warps_distinct(slots):
    """16-byte shared accesses are served eight threads at a time: the
    eight slots must lie in eight different groups of four banks."""
    return all(len(set(g % 8)) == 8 for g in slots.reshape(-1, 8))


def k1_walk(p2, vm, n, k, canonical):
    """encode_2bit_kernel over n windows, block by block, the block's
    threads as numpy vectors: returns (keyed u64, valid u8, whether every
    16-byte shared access is free of bank conflicts)."""
    packed_vecs = (BLOCK // 4 + 16) // 16  # kPackedVecs
    valid_vecs = (BLOCK // 8 + 16) // 16  # kValidVecs
    keyed = np.full(n, POISON, np.uint64)
    valid = np.full(n, 7, np.uint8)
    banks_ok = True
    t = np.arange(THREADS)
    mask = ~U64(0) if k == 32 else U64((1 << (2 * k)) - 1)
    for b in range(-(-n // BLOCK)):
        first = b * BLOCK
        words = span16(p2, first // 4, packed_vecs).view("<u8")
        vwords = span16(vm, first // 8, valid_vecs).view("<u4").astype(U64)
        lo, hi = words[t], words[t + 1]
        fwd = rev2_np(lo) >> U64(64 - 2 * k)
        rc = ~lo & mask
        inn = hi if k == 32 else (lo >> U64(2 * k)) | (hi << U64(64 - 2 * k))
        run = vwords[t] | (vwords[t + 1] << U64(32))
        have = 1
        while have < k:
            step = min(have, k - have)
            run &= run >> U64(step)
            have += step
        i0 = first + t * W
        last = n - k - i0
        ok = (run & U64(0xFFFFFFFF)).astype(np.int64)
        ok = np.where(last < 0, 0, np.where(
            last < W - 1, ok & ((2 << np.clip(last, 0, 62)) - 1), ok))
        stage = np.full((BLOCK // 2, 2), POISON, np.uint64)
        for s in range(W // 2):
            pair = []
            for h in range(2):
                j = 2 * s + h
                if j > 0:
                    base = inn & U64(3)
                    inn = inn >> U64(2)
                    fwd = ((fwd << U64(2)) | base) & mask
                    rc = (rc >> U64(2)) | ((U64(3) ^ base) << U64(2 * k - 2))
                code = np.where(canonical & (rc < fwd), rc, fwd)
                pair.append(np.where((ok >> j) & 1 == 1, code, ~U64(0)))
            slot = t * (W // 2) + (s ^ (t & 15))  # key_slot
            banks_ok &= quarter_warps_distinct(slot)
            stage[slot] = np.stack(pair, 1)
        for tt in range(THREADS):  # each thread's flag bytes
            m = min(W, n - int(i0[tt]))
            valid[i0[tt]:i0[tt] + max(m, 0)] = (int(ok[tt]) >> np.arange(
                max(m, 0))) & 1
        assert (stage != POISON).all()  # every slot staged
        p = np.arange(BLOCK // 2)  # the copy-out, 16 bytes a thread
        slot = (p // (W // 2)) * (W // 2) + ((p % (W // 2)) ^ ((p // (W // 2)) & 15))
        banks_ok &= quarter_warps_distinct(slot)
        keys = stage[slot].reshape(-1)[:n - first]
        keyed[first:first + len(keys)] = keys
    return keyed, valid, banks_ok


K1_WALK_NS = (0, 1, W - 1, W, W + 1, BLOCK - 1, BLOCK + 1, 4099)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 5, 23, 31, 32])
def test_k1_walk_matches_plain_and_pallas(k, canonical):
    rng = np.random.default_rng(200 + k)
    for n in K1_WALK_NS:
        bases = random_bases(rng, n, p_invalid=0.03)
        p2, vm = pack_bases_2bit(bases)
        got_keyed, got_valid, banks_ok = k1_walk(p2, vm, n, k, canonical)
        keyed, valid = encode_2bit_plain(torch.from_numpy(p2),
                                         torch.from_numpy(vm), n, k, canonical)
        np.testing.assert_array_equal(got_valid, valid.numpy(), err_msg=f"n={n}")
        np.testing.assert_array_equal(got_keyed, keyed.numpy().view(np.uint64),
                                      err_msg=f"n={n}")
        assert banks_ok
    codes, pvalid = encode_canonical_pallas(jnp.asarray(bases), k, canonical,
                                            interpret=True)
    np.testing.assert_array_equal(
        got_keyed, np.where(np.asarray(pvalid), np.asarray(codes), SENT))
    np.testing.assert_array_equal(got_valid.astype(bool), np.asarray(pvalid))


def test_k1_walk_poly_t_real_sentinel():
    bases = np.full(BLOCK + 40, 3, np.uint8)
    bases[[100, 2000]] = 255
    p2, vm = pack_bases_2bit(bases)
    keyed, valid, _ = k1_walk(p2, vm, len(bases), 32, False)
    want = numpy_keyed(bases, 32, False)
    np.testing.assert_array_equal(keyed, want[0])
    np.testing.assert_array_equal(valid.astype(bool), want[1])
    assert ((keyed == SENT) & (valid == 1)).sum() > BLOCK // 2


def test_k1_walk_catches_an_unswizzled_stage():
    """The stage's swizzle is what keeps the 16-byte writes conflict-free:
    without it eight threads hit one bank group."""
    slot = np.arange(THREADS) * (W // 2)
    assert not quarter_warps_distinct(slot)
