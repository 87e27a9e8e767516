"""The Fiat-Shamir tape of the round kernels (csrc/fs_tape.cuh) built for
the host with g++: SHA-512, the tape's absorb and draw and the digest's
reduction mod p against hashlib and the port's FiatShamirTape, byte for
byte; and the finish of a quadratic round (the message with add_term,
the sides that exhaust, the absorb and the draw, then the last fold),
driven over a whole phase, against the engine's host code
(PhaseEngine.round and receive under the host tape).

Tolerance 0.  Inputs come from np.random.default_rng(seed).  The tests
skip where there is no g++.
"""

import ctypes
import hashlib
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from zkcnn_tpu_torch.field import FR, FR_P
from zkcnn_tpu_torch.field.round_kernels import HEAD_ROWS, phase_head, \
    phase_rows, read_phase
from zkcnn_tpu_torch.gkr import FiatShamirTape
from zkcnn_tpu_torch.gkr.engine import Side, PhaseEngine

_HARNESS = r"""
#include <vector>
#define ZK_DEV
#define ZK_DEV_NOINLINE
#define ZK_CONST static const
#include "fs_tape.cuh"
using fr::u32;
using fr::NW;

extern "C" {
void h_sha512(u32* out, const u32* bytes, int n) {
  fs::Sha512 s;
  s.init();
  s.update_words(bytes, n);
  s.final(out);
}
void h_absorb(u32* state, const u32* vals, int k) {
  fs::fs_absorb(state, vals, k);
}
void h_draw(u32* r, const u32* state, u32* counter) {
  fs::fs_draw(r, state, counter);
}
void h_reduce(u32* r, const u32* digest, long long n) {
  for (long long i = 0; i < n; ++i)
    fs::digest_to_fr(r + i * NW, digest + i * fs::STATE_WORDS);
}
// A quadratic phase of n rounds on the header's primitives, in the order
// the kernels run them: round j folds the sides at r_(j-1), sums the
// active sides' pair dots, joins the sides that exhaust and finishes
// (fs::quad_finish); the last fold and fs::quad_receive close it.  Side s:
// rows[s] = 2^nb[s] rows of A and V (nb[s] < 0: none); fin [2, 2, 8].
void h_quad_phase(const u32* A0, const u32* V0, const u32* A1,
                  const u32* V1, const int* nb, int n, int include,
                  const u32* head, u32* buf, u32* fin) {
  fs::Head h;
  for (int i = 0; i < fs::HEAD_WORDS; ++i) h.w[i] = head[i];
  h.add = nullptr;
  fs::phase_init(buf, h);
  std::vector<u32> cur[2][2];
  long long rows[2];
  const u32* src[2][2] = {{A0, V0}, {A1, V1}};
  for (int s = 0; s < 2; ++s) {
    rows[s] = nb[s] < 0 ? 0 : 1LL << nb[s];
    for (int o = 0; o < 2; ++o)
      if (rows[s]) cur[s][o].assign(src[s][o], src[s][o] + rows[s] * NW);
  }
  auto fold = [&](int s, const u32* r) {
    for (int o = 0; o < 2; ++o) {
      std::vector<u32> out(rows[s] / 2 * NW);
      for (long long i = 0; i < rows[s] / 2; ++i)
        fr::fold_at(&out[i * NW], &cur[s][o][2 * i * NW],
                    &cur[s][o][(2 * i + 1) * NW], r);
      cur[s][o] = out;
    }
    rows[s] /= 2;
  };
  for (int j = 0; j < n; ++j) {
    const u32* rp = j ? fs::phase_r(buf, j - 1) : nullptr;
    u32 dots[2][4][NW], prod[2][NW];
    int nd = 0, nj = 0;
    for (int s = 0; s < 2; ++s) {
      if (!rows[s]) continue;
      if (j < nb[s]) {
        if (j) fold(s, rp);
        for (int v = 0; v < 4; ++v) {
          fr::set_zero(dots[nd][v]);
          for (long long i = 0; i < rows[s] / 2; ++i) {
            u32 t[NW];
            fr::fr_mul(t, &cur[s][0][(2 * i + (v >> 1)) * NW],
                       &cur[s][1][(2 * i + (v & 1)) * NW]);
            fr::add_mod(dots[nd][v], dots[nd][v], t);
          }
        }
        ++nd;
      } else {
        fs::join_side(prod[nj++], fin + 2 * s * NW, cur[s][0].data(),
                      cur[s][1].data(), rp);
        rows[s] = 0;
      }
    }
    fs::quad_finish(buf, n, j, dots[0][0], nd, prod[0], nj, include != 0);
  }
  for (int s = 0; s < 2; ++s) {
    if (!rows[s]) continue;
    fold(s, fs::phase_r(buf, n - 1));
    fr::copy(fin + 2 * s * NW, cur[s][0].data());
    fr::copy(fin + (2 * s + 1) * NW, cur[s][1].data());
  }
  fs::quad_receive(buf, n, include != 0);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the device tape for the host")
    csrc = pathlib.Path(__file__).resolve().parents[1] / "zkcnn_tpu_torch" \
        / "csrc"
    tmp = tmp_path_factory.mktemp("fstape")
    src = tmp / "harness.cpp"
    src.write_text(_HARNESS)
    path = tmp / "libfstape.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{csrc}", "-o", str(path),
                    str(src)], check=True)
    return ctypes.CDLL(str(path))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _state_words(state: bytes):
    return np.frombuffer(state, "<u4").copy()


def test_absorb_and_draw_match_hashlib_and_the_host_tape(lib):
    """SHA-512 of messages of 0 to 256 bytes, eight at a time; then random
    states, absorbs of one to four values among 0, 1, p - 1 and random
    ones, draws at counters 0, 255, 256, 2^32 and random ones: the device
    tape's state, challenge and counter equal FiatShamirTape's and
    hashlib's, byte for byte."""
    rng = np.random.default_rng(11)
    for n in range(0, 264, 8):          # every length the blocks can end at
        msg = rng.bytes(n)
        out = np.zeros(16, np.uint32)
        lib.h_sha512(_ptr(out), _ptr(np.frombuffer(msg + b"\0" * 8, "<u4")),
                     n)
        assert out.tobytes() == hashlib.sha512(msg).digest(), n
    edge = [0, 1, FR_P - 1]
    counters = [0, 255, 256, 1 << 32, (1 << 32) - 1]
    for case in range(300):
        state = rng.bytes(64)
        k = case % 4 + 1
        vals = [edge[(case + i) % 3] if case < 60 else
                int.from_bytes(rng.bytes(32), "little") % FR_P
                for i in range(k)]
        counter = counters[case % 5] if case % 2 else \
            int(rng.integers(0, 1 << 62))
        host = FiatShamirTape()
        host.state, host.counter = state, counter
        host.absorb(*vals)
        want_r = host.field()
        h = hashlib.sha512(state)
        for v in vals:
            h.update(v.to_bytes(32, "little"))
        assert host.state == h.digest()
        st = _state_words(state)
        lib.h_absorb(_ptr(st), _ptr(FR.pack_mont_host(vals)), k)
        assert st.tobytes() == h.digest()
        r = np.zeros(8, np.uint32)
        ctr = np.array([counter & 0xFFFFFFFF, counter >> 32], np.uint32)
        lib.h_draw(_ptr(r), _ptr(st), _ptr(ctr))
        assert FR.from_mont_host(r) == want_r
        d = hashlib.sha512(h.digest() + counter.to_bytes(8, "little"))
        assert want_r == int.from_bytes(d.digest(), "little") % FR_P
        assert int(ctr[0]) | int(ctr[1]) << 32 == host.counter == counter + 1


def test_digest_reduction_at_the_edges(lib):
    """64-byte digests read as little-endian integers mod p: 0, all 0xff,
    every multiple k p below 2^512 near its ends and random ones, and k p
    - 1, k p + 1 beside them."""
    rng = np.random.default_rng(12)
    top = (1 << 512) // FR_P
    ks = [1, 2, 3, (1 << 256) // FR_P, (1 << 256) // FR_P + 1, top - 1, top]
    ks += [int.from_bytes(rng.bytes(32), "little") % top for _ in range(50)]
    xs = [0, (1 << 512) - 1, (1 << 256) - 1, 1 << 256]
    for k in ks:
        xs += [x for x in (k * FR_P - 1, k * FR_P, k * FR_P + 1)
               if 0 <= x < 1 << 512]
    xs += [int.from_bytes(rng.bytes(64), "little") for _ in range(200)]
    digests = np.stack([np.frombuffer(x.to_bytes(64, "little"), "<u4")
                        for x in xs])
    out = np.zeros((len(xs), 8), np.uint32)
    lib.h_reduce(_ptr(out), _ptr(digests), ctypes.c_longlong(len(xs)))
    assert FR.unpack_mont_host(out.view(np.int32)) == [x % FR_P for x in xs]


def _rand(rng, m):
    return torch.from_numpy(FR.pack_mont_host(
        [int.from_bytes(rng.bytes(32), "little") % FR_P for _ in range(m)]))


# (nb of each side, -1 for none; rounds; add_term in the messages): both
# sides exhaust, one at round 2 and one at 4; both end with the last fold;
# a side of two rows; a side of one row, which joins in round 0; Liu's
# phase (add_term stays out)
PHASES = [((4, 2), 5, True), ((5, 5), 5, True), ((1, 3), 3, True),
          ((-1, 0), 3, True), ((-1, 6), 6, False)]


def test_finish_matches_the_engine(lib):
    """A phase run on the header's finish against PhaseEngine.round and
    receive under the host tape, at each of PHASES: every message,
    challenge, add_term, the tape's state and counter, and each side's
    last rows."""
    for nbs, n, include in PHASES:
        _finish_matches_the_engine(lib, nbs, n, include)


def _finish_matches_the_engine(lib, nbs, n, include):
    rng = np.random.default_rng(13 + n)
    add = int.from_bytes(rng.bytes(32), "little") % FR_P if include else 0
    ops = [(_rand(rng, 1 << nb), _rand(rng, 1 << nb)) if nb >= 0 else None
           for nb in nbs]
    tape = FiatShamirTape(b"device-tape")
    head = phase_head(tape.state, tape.counter, add)
    engine = PhaseEngine([Side(*o, nb) if o else None
                          for o, nb in zip(ops, nbs)],
                         add_term=add, include_add_term=include)
    polys, rs, prev = [], [], None
    for _ in range(n):
        polys.append(engine.round(prev))
        tape.absorb(*polys[-1])
        prev = tape.field()
        rs.append(prev)
    engine.receive(prev)

    buf = np.zeros((phase_rows(n, 3), 8), np.int32)
    fin = np.zeros((2, 2, 8), np.int32)
    zero = np.zeros((1, 8), np.int32)
    arrs = [np.ascontiguousarray(x.numpy()) if o else zero
            for o in ops for x in (o or (None, None))]
    lib.h_quad_phase(*(_ptr(a) for a in arrs),
                     _ptr(np.array(nbs, np.int32)), n, int(include),
                     _ptr(head), _ptr(buf), _ptr(fin))
    state, counter, add_after, got_rs, got = read_phase(buf, n, 3)
    assert got == polys and got_rs == rs
    assert (state, counter) == (tape.state, tape.counter)
    if include:
        assert add_after == engine.add_term
    for k, s in enumerate(engine.sides):
        if s is not None:
            assert FR.unpack_mont_host(fin[k]) == \
                FR.unpack_mont_host(torch.stack([s.A[0], s.V[0]]).numpy())
    assert buf.shape[0] == HEAD_ROWS + 4 * n
