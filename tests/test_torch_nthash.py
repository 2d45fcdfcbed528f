"""The port's ntHash (ops/nthash.py) and H1 (plain version on the CPU)
against the JAX package's ops/nthash.py and window_codes, and H1's kernel
(csrc/nthash.cu) walked thread by thread in numpy.  Exact equality
throughout: hashes are integers.  The CUDA kernel itself is held to the
plain version on the card (marked ``cuda``; skipped without one)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unikmer_tpu.models import count as jax_count
from unikmer_tpu.ops import nthash as jax_nthash
from unikmer_tpu_torch.models.count import pack_bases_2bit
from unikmer_tpu_torch.ops import nthash

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
U64 = np.uint64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def bases_with_n_runs(rng, n):
    """Random bases with invalid singletons and runs of N (255)."""
    b = rng.integers(0, 4, size=n, dtype=np.uint8)
    b[rng.random(n) < 0.01] = rng.integers(4, 256, dtype=np.uint8)
    for a in rng.integers(0, max(n, 1), size=n // 300):
        b[a:a + int(rng.integers(1, 40))] = 255
    return b


def test_seed_tables_match_jax():
    for name in ("SEED_A", "SEED_C", "SEED_G", "SEED_T", "SEED_N",
                 "_SEEDS_FWD", "_SEEDS_RC", "MAX_K"):
        np.testing.assert_array_equal(getattr(nthash, name),
                                      getattr(jax_nthash, name), err_msg=name)


NTHASH_KS = (1, 2, 3, 5, 8, 13, 21, 31, 32, 33, 47, 63, 64)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", NTHASH_KS)
def test_nthash_windows_matches_jax(k, canonical):
    rng = np.random.default_rng(300 + k)
    for n in (0, 1, k - 1, k, k + 1, 2000):  # and inputs shorter than k
        b = bases_with_n_runs(rng, n)
        want = np.asarray(jax_nthash.nthash_windows(jnp.asarray(b), k,
                                                    canonical))
        got = nthash.nthash_windows(torch.from_numpy(b), k, canonical)
        np.testing.assert_array_equal(got.numpy().view(np.uint64), want,
                                      err_msg=f"n={n}")
        np.testing.assert_array_equal(
            nthash.nthash_windows_np(b, k, canonical), want, err_msg=f"n={n}")


def test_nthash_kmer_and_rows_match_jax():
    rng = np.random.default_rng(5)
    for k in (1, 21, 33, 64):
        rows = rng.integers(0, 4, size=(50, k), dtype=np.uint8)
        for canonical in (False, True):
            np.testing.assert_array_equal(
                nthash.nthash_rows_np(rows, canonical),
                jax_nthash.nthash_rows_np(rows, canonical))
        for kmer in ("ACGT" * 16)[:k], "".join(rng.choice(list("ACGTN"), k)):
            for canonical in (False, True):
                assert (nthash.nthash_kmer(kmer, canonical)
                        == jax_nthash.nthash_kmer(kmer, canonical))


@pytest.mark.parametrize("scale", [0, 1, 2, 15, 1000, 2**32 - 1])
def test_scaled_max_hash_matches_jax(scale):
    got = nthash.scaled_max_hash(scale)
    assert got == jax_nthash.scaled_max_hash(scale)
    assert 0 < got < 2**64


WINDOW_CONFIGS = [
    dict(k=21, hashed=True),
    dict(k=31, hashed=True, canonical=True),
    dict(k=40),
    dict(k=64, canonical=True),
    dict(k=21, scale=4, canonical=True),
    dict(k=31, scale=15, canonical=True),
    dict(k=33, scale=1000),
]


@pytest.mark.parametrize("kw", WINDOW_CONFIGS, ids=str)
def test_encode_nthash_plain_matches_jax_window_codes(kw):
    cfg = jax_count.CountConfig(**kw)
    assert cfg.hashed
    rng = np.random.default_rng(cfg.k + cfg.scale)
    n = 5003
    b = bases_with_n_runs(rng, n)
    codes, valid = jax_count.window_codes(jnp.asarray(b), cfg)
    codes, valid = np.asarray(codes), np.asarray(valid)
    p2, vm = pack_bases_2bit(b)
    keyed, got_valid = nthash.encode_nthash(
        torch.from_numpy(p2), torch.from_numpy(vm), n, cfg.k, cfg.canonical,
        nthash.scaled_max_hash(cfg.scale))
    np.testing.assert_array_equal(got_valid.numpy().astype(bool), valid)
    np.testing.assert_array_equal(keyed.numpy().view(np.uint64),
                                  np.where(valid, codes, SENT))
    assert valid.sum() > n // (5 * cfg.scale)


def test_encode_nthash_rejects_bad_inputs():
    p2 = torch.zeros(2, dtype=torch.uint8)
    vm = torch.zeros(1, dtype=torch.uint8)
    with pytest.raises(ValueError):
        nthash.encode_nthash(p2, vm, 9, 5, True)  # 9 bases need 3 packed bytes
    with pytest.raises(ValueError):
        nthash.encode_nthash(p2, vm, 8, 65, True)
    with pytest.raises(ValueError):
        nthash.encode_nthash(p2, vm, 8, 5, True, max_hash=1 << 64)
    with pytest.raises(ValueError):
        nthash.encode_nthash(p2.to(torch.int32), vm, 8, 5, True)
    keyed, valid = nthash.encode_nthash(p2, vm, 8, 64, True)
    assert keyed.shape == valid.shape == (8,) and not valid.any()


# ---------------------------------------------------------------------
# H1's kernel walked block by block and thread by thread in numpy
# (csrc/nthash.cu; its constants and seeds are read from the source)

CSRC = (Path(__file__).resolve().parent.parent / "unikmer_tpu_torch" / "csrc"
        / "nthash.cu").read_text()


def cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CSRC).group(1))


def cu_seed(base):
    return U64(int(re.search(rf"constexpr uint64_t kSeed{base} = (0x[0-9A-F]+)ull;",
                             CSRC).group(1), 16))


THREADS, W = cu_const("kThreads"), cu_const("kW")
BLOCK = THREADS * W
PACKED_VECS = (BLOCK // 4 + 16) // 16  # kPackedVecs
VALID_VECS = (BLOCK // 8 + 16) // 16  # kValidVecs
POISON = U64(0x5A5A5A5A5A5A5A5A)
F_IN = np.array([cu_seed(c) for c in "ACGT"], np.uint64)
RC = F_IN[::-1].copy()


def rol(x, s):
    """The kernel's rol: (x << s) | (x >> ((64 - s) & 63)), 0 <= s < 64."""
    return (x << U64(s)) | (x >> U64((64 - s) & 63))


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


def h1_walk(p2, vm, n, k, canonical, max_hash):
    """encode_nthash_kernel over n windows, block by block, the block's
    threads as numpy vectors: (keyed u64, valid u8, whether every 16-byte
    shared access is free of bank conflicts).  A word index past the
    span raises IndexError."""
    keyed = np.full(n, POISON, np.uint64)
    valid = np.full(n, 7, np.uint8)
    banks_ok = True
    t = np.arange(THREADS)
    f_out, r_in, r_out = rol(F_IN, k & 63), rol(RC, (k - 1) & 63), rol(RC, 63)
    mh = U64(max_hash)
    for blk in range(-(-n // BLOCK)):
        first = blk * BLOCK
        words = span16(p2, first // 4, PACKED_VECS).view("<u8")
        vwords = span16(vm, first // 8, VALID_VECS).view("<u4").astype(U64)
        w0, w1, w2 = words[t], words[t + 1], words[t + 2]
        f = np.zeros(THREADS, np.uint64)
        r = np.zeros(THREADS, np.uint64)
        cur = w0
        for j in range(k):  # the first window, hashed directly
            if j == 32:
                cur = w1
            b = (cur & U64(3)).astype(np.int64)
            cur = cur >> U64(2)
            f = rol(f, 1) ^ F_IN[b]
            r = r ^ rol(RC[b], j)
        out = w0
        wi, sh = k >> 5, 2 * (k & 31)
        lo, hi = (w0, w1, w2)[wi], (w1, w2, w2)[wi]
        inn = (lo >> U64(sh)) | (hi << U64(64 - sh)) if sh else lo
        vlo = vwords[t] | (vwords[t + 1] << U64(32))
        vhi = vwords[t + 2]
        have = 1
        while have < k:
            step = min(have, k - have)
            assert 1 <= step <= 32
            vlo = vlo & ((vlo >> U64(step)) | (vhi << U64(64 - step)))
            vhi = vhi & (vhi >> U64(step))
            have += step
        i0 = first + t * W
        last = n - k - i0
        ok = (vlo & U64(0xFFFFFFFF)).astype(np.int64)
        ok = np.where(last < 0, 0, np.where(
            last < W - 1, ok & ((2 << np.clip(last, 0, 62)) - 1), ok))
        kept = np.zeros(THREADS, np.int64)
        stage = np.full((BLOCK // 2, 2), POISON, np.uint64)
        for s in range(W // 2):
            pair = []
            for h in range(2):
                j = 2 * s + h
                if j > 0:
                    bo = (out & U64(3)).astype(np.int64)
                    bi = (inn & U64(3)).astype(np.int64)
                    out, inn = out >> U64(2), inn >> U64(2)
                    f = rol(f, 1) ^ f_out[bo] ^ F_IN[bi]
                    r = rol(r, 63) ^ r_out[bo] ^ r_in[bi]
                code = np.where(canonical & (r < f), r, f)
                keep = ((ok >> j) & 1 == 1) & (code <= mh)
                kept |= keep.astype(np.int64) << j
                pair.append(np.where(keep, code, SENT))
            slot = t * (W // 2) + (s ^ (t & 15))  # key_slot
            banks_ok &= quarter_warps_distinct(slot)
            stage[slot] = np.stack(pair, 1)
        for tt in range(THREADS):  # each thread's flag bytes
            m = max(min(W, n - int(i0[tt])), 0)
            valid[i0[tt]:i0[tt] + m] = (int(kept[tt]) >> np.arange(m)) & 1
        assert (stage != POISON).all()  # every slot staged
        p = np.arange(BLOCK // 2)  # the copy-out, 16 bytes a thread
        slot = (p // (W // 2)) * (W // 2) + ((p % (W // 2)) ^ ((p // (W // 2)) & 15))
        banks_ok &= quarter_warps_distinct(slot)
        keys = stage[slot].reshape(-1)[:n - first]
        keyed[first:first + len(keys)] = keys
    return keyed, valid, banks_ok


H1_WALK_NS = (0, 1, W - 1, W, W + 1, BLOCK - 1, BLOCK, BLOCK + 1,
              2 * BLOCK + 63, 2 * BLOCK + 64)


@pytest.mark.parametrize("scale", [1, 15])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 31, 33, 64])
def test_h1_walk_matches_plain(k, canonical, scale):
    rng = np.random.default_rng(400 + k)
    max_hash = nthash.scaled_max_hash(scale)
    for n in H1_WALK_NS:
        bases = bases_with_n_runs(rng, n)
        p2, vm = pack_bases_2bit(bases)
        got_keyed, got_valid, banks_ok = h1_walk(p2, vm, n, k, canonical,
                                                 max_hash)
        keyed, valid = nthash.encode_nthash_plain(
            torch.from_numpy(p2), torch.from_numpy(vm), n, k, canonical,
            max_hash)
        np.testing.assert_array_equal(got_valid, valid.numpy(), err_msg=f"n={n}")
        np.testing.assert_array_equal(got_keyed, keyed.numpy().view(np.uint64),
                                      err_msg=f"n={n}")
        assert banks_ok


def test_h1_walk_all_valid_last_block():
    """k = 64 over all-valid bases: the last thread of every block reads
    word t + 2 of the span's halo, and the ragged last block's windows up
    to n - k are all kept."""
    rng = np.random.default_rng(9)
    n = 3 * BLOCK + 100
    bases = rng.integers(0, 4, size=n, dtype=np.uint8)
    p2, vm = pack_bases_2bit(bases)
    keyed, valid, _ = h1_walk(p2, vm, n, 64, True, nthash.MAX_HASH)
    assert valid[:n - 63].all() and not valid[n - 63:].any()
    np.testing.assert_array_equal(
        keyed[:n - 63], jax_nthash.nthash_windows_np(bases, 64, True)[:n - 63])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 31, 32, 33, 63, 64])
def test_h1_kernel_matches_plain_on_card(cuda_device, k):
    rng = np.random.default_rng(k)
    for n in (1, 7, 31, 32, 33, 4095, 4096, 4097, 8193, 4099, (1 << 20) + 3):
        p2, vm = pack_bases_2bit(bases_with_n_runs(rng, n))
        p2 = torch.from_numpy(p2).to(cuda_device)
        vm = torch.from_numpy(vm).to(cuda_device)
        for canonical in (False, True):
            for scale in (1, 15):
                mh = nthash.scaled_max_hash(scale)
                got = nthash.encode_nthash(p2, vm, n, k, canonical, mh)
                want = nthash.encode_nthash_plain(p2, vm, n, k, canonical, mh)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
