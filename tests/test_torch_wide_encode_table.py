"""The forward encode kernels K1 and K5 in table form, as plain walks.

csrc/wide_encode_step.cuh runs each lane's state machine in its own warps
ahead of the model: the state warps walk the table (ops/wide_kernels.py
sm_table) and write one word per step (context, bit, active), a finished
lane's context being the sink row; the model warps run the model, and K5's
range coder, over those words.  This holds because every lane's active
fields are a prefix of the iterations, which the first tests check on the
native host walker's planes and on the device schedule's.  The walks below
mirror the kernels' steps with the table helpers (_sm_key, _sm_apply) and
must reproduce model_probs_plain's plane and rc_encode_plain's units, and
the JAX package's model kernel (interpret mode) on the 48 KB corpus of
tests/test_torch_wide_model.py; the kernels' own form of the table
(sm_enc_table: histories and a key word instead of val and rank) must give
the same contexts.  All comparisons are exact (tolerance 0:
the codec is lossless)."""

import numpy as np
import pytest
import torch

from chip_smoke import hard_blocks, lane_planes
from libbsc_tpu_torch.ops import wide as pwide
from libbsc_tpu_torch.ops import wide_kernels as pwk
from libbsc_tpu_torch.ops import wide_schedule as psched
from tests.conftest import make_corpus

STEPS = 32  # the kernels' context chunk (kSteps)


def _skewed_sizes(n: int, seed: int) -> np.ndarray:
    """Log-normal spans with group 2 empty and every third lane of group 5
    dead, capped at 4x the mean, as chip_smoke.py's skewed hard block."""
    g = np.random.default_rng(seed)
    w = g.lognormal(0.0, 0.75, pwk.LANES)
    w[256:384] = 0
    w[640:768:3] = 0
    w = np.minimum(w, 4 * w[w > 0].mean())
    sizes = np.floor(w / w.sum() * n).astype(np.int64)
    live = np.nonzero(w)[0]
    sizes[live[:n - sizes.sum()]] += 1
    return sizes.astype(np.int32)


def _case(name: str):
    """(planes u8 [IT/4, 1024], lane sizes, max_bits) of one block."""
    g = np.random.default_rng(459)
    if name == "text":  # tests/test_torch_wide_model.py's input
        data = make_corpus(g, 1024 * 48, "text")
        planes, sizes, max_bits, _ = pwk._host_prep(data)
        return planes, sizes, max_bits
    if name == "dead_lanes":  # the equal split: 1000 live lanes
        data = make_corpus(g, 1024 * 36 + 123, "text")
        return lane_planes(data, pwide.lane_sizes(len(data), pwk.LANES))
    if name == "random":  # ranks up to 255
        data = np.where(g.random(1 << 15) < 0.3, 0,
                        g.integers(0, 256, 1 << 15)).astype(np.uint8)
        planes, sizes, max_bits, _ = pwk._host_prep(data.tobytes())
        return planes, sizes, max_bits
    if name == "zeros":  # runs over 2^16: the run exponent passes 16
        return lane_planes(*hard_blocks(b"")["zeros"])
    assert name == "skewed"  # an empty group and dead lanes
    data = make_corpus(g, 1 << 15, "text")
    return lane_planes(data, _skewed_sizes(len(data), 5))


CASES = ["text", "dead_lanes", "random", "zeros", "skewed"]


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name) for name in CASES}


def _fields(planes: np.ndarray) -> np.ndarray:
    """int [4 * rows, 1024]: the 2-bit field of every iteration and lane."""
    shifts = np.array([0, 2, 4, 6], np.uint8)[None, :, None]
    f = (planes[:, None, :] >> shifts) & 3
    return f.reshape(-1, planes.shape[1])


def _assert_active_prefix(planes, sizes):
    active = (_fields(np.asarray(planes)) & 2) != 0
    # once a lane's field is inactive, every later one is
    assert not (active[1:] & ~active[:-1]).any()
    assert not active[:, np.asarray(sizes) == 0].any()  # dead lanes
    assert active[0, np.asarray(sizes) > 0].all()  # live from iteration 0


@pytest.mark.parametrize("name", CASES)
def test_host_walker_active_fields_are_a_prefix(cases, name):
    planes, sizes, _ = cases[name]
    _assert_active_prefix(planes, sizes)


@pytest.mark.parametrize("kind", ["text", "random"])
def test_device_schedule_active_fields_are_a_prefix(kind):
    g = np.random.default_rng(77)
    data = make_corpus(g, 1024 * 40 + 17, kind)
    u = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    planes, sizes, max_bits, IT = pwk.resident_prep(u)
    assert planes.device.type == "cpu" and planes.shape == (IT // 4, 1024)
    _assert_active_prefix(planes.numpy(), sizes)
    active = (_fields(planes.numpy()) & 2) != 0
    assert active[:max_bits].any(axis=1).all()  # max_bits is the longest
    assert not active[max_bits:].any()
    assert np.array_equal(
        sizes, psched.device_balanced_sizes(u, pwk.LANES).numpy())


def _words(planes: np.ndarray, max_bits: int):
    """The state warps' words, split: context (the sink row where the
    field is inactive), bit and active, each int64 [max_bits, 1024]."""
    tab = pwk.sm_table_tensor("cpu").long()
    z = torch.zeros(pwk.LANES, dtype=torch.int64)
    pos, base = z.clone(), z.clone()
    kind = torch.full_like(z, pwk.KEY_RH)
    rh, uh, prb, pub, val, rank = (z.clone() for _ in range(6))
    pl = torch.from_numpy(planes)
    ctxs, bits, acts = [], [], []
    for i in range(max_bits):
        fld = pwk._fields(pl, i)
        bit, active = fld & 1, (fld & 2) != 0
        key = pwk._sm_key(kind, rh, uh, prb, pub, val, rank)
        ctxs.append(torch.where(active, base + key, pwk.SM_SINK))
        bits.append(bit)
        acts.append(active)
        (pos, base, kind, rh, uh, prb, pub, val, rank,
         _) = pwk._sm_apply(tab, pos, bit, rh, uh, prb, pub, val, rank)
    return torch.stack(ctxs), torch.stack(bits), torch.stack(acts)


def _enc_words(planes: np.ndarray, max_bits: int):
    """The state warps' contexts as csrc/wide_sm_table.cuh's encoder lane
    computes them (EncLane, enc_ctx, enc_next over sm_enc_table): int64
    [max_bits, 1024], the sink row where the field is inactive."""
    et = torch.from_numpy(pwk.sm_enc_table()).long()
    z = torch.zeros(pwk.LANES, dtype=torch.int64)
    pos, base = z.clone(), z.clone()
    kw = torch.full_like(z, pwk.enc_key_word(pwk.KEY_RH))
    rh, uh, prb, pub, rb, vc = (z.clone() for _ in range(6))
    pl = torch.from_numpy(planes)
    w = torch.where
    ctxs = []
    for i in range(max_bits):
        fld = pwk._fields(pl, i)
        bit, active = fld & 1, (fld & 2) != 0
        h = rh | uh << 4 | prb << 8 | pub << 10 | rb << 12 | vc << 14
        key = (((h >> (kw & 31)) & ((kw >> 5) & 15)) * ((kw >> 9) & 31)
               + ((h >> ((kw >> 14) & 31)) & ((kw >> 19) & 3))
               * ((kw >> 21) & 31))
        ctxs.append(w(active, base + key, pwk.SM_SINK))
        a, b = et[pos, 2 * bit], et[pos, 2 * bit + 1]
        hist, vmode, rmode = (a >> 18) & 3, (a >> 20) & 3, (a >> 22) & 3
        vs = torch.clamp((vc << 1) | bit, max=15)
        rh = w(hist == 1, ((rh << 1) | bit) & 15, rh)
        uh = w(hist == 2, ((uh << 1) | bit) & 15, uh)
        vc = w(vmode == 1, vs, w(vmode == 2, 1, vc))
        rb = w(rmode == 1, 0, w(rmode == 2, 1,
                                w(rmode == 3, w(vs <= 2, 1, 2), rb)))
        prb = w(((a >> 24) & 3) == 3, prb, (a >> 24) & 3)
        pub = w(((a >> 26) & 3) == 3, pub, (a >> 26) & 3)
        pos, base, kw = a & 511, (a >> 9) & 511, b
    return torch.stack(ctxs)


@pytest.mark.parametrize("name", CASES)
def test_encoder_table_walk_equals_the_table_walk(cases, name):
    planes, _, max_bits = cases[name]
    assert torch.equal(_enc_words(planes, max_bits),
                       _words(planes, max_bits)[0])


def test_encoder_table_derives_from_the_table():
    tab, enc = pwk.sm_table(), pwk.sm_enc_table()
    assert enc.shape == tab.shape == (pwk.SM_NPOS, 4)
    for bit in (0, 1):
        a, ea = tab[:, 2 * bit], enc[:, 2 * bit]
        assert np.array_equal(ea & 511, a & 511)  # the next position
        kind = (a >> 18) & 7
        assert np.array_equal(((ea >> 9) & 511) + (kind == pwk.KEY_RMAN),
                              (a >> 9) & 511)
        assert np.array_equal((ea >> 18) & 63, (a >> 21) & 63)
        assert np.array_equal((ea >> 24) & 15, tab[:, 2 * bit + 1] & 15)
        assert (ea >> 28 == 0).all()
        assert np.array_equal(enc[:, 2 * bit + 1], [
            pwk.enc_key_word(int(k)) for k in kind])


def _model_rows():
    """Every lane's model: the priors, then the sink row."""
    model = torch.zeros((pwk.LANES, pwk.SM_SINK + 1), dtype=torch.int64)
    model[:, :pwk.SM_SINK] = pwk.priors_tensor("cpu").long()
    model[:, pwk.SM_SINK] = 2048
    return model


def model_walk(planes: np.ndarray, max_bits: int) -> torch.Tensor:
    """K1's step in table form: the words, then the model warps' plane
    (p where the field is active, else 0; a finished lane adapts the
    sink row)."""
    ctx, bit, act = _words(planes, max_bits)
    model = _model_rows()
    lanes = torch.arange(pwk.LANES)
    out = torch.zeros((4 * planes.shape[0], pwk.LANES), dtype=torch.int32)
    for i in range(max_bits):
        p = model[lanes, ctx[i]]
        model[lanes, ctx[i]] = pwk._adapt(p, bit[i])
        out[i] = torch.where(act[i], p, 0).to(torch.int32)
    return out


def rc_walk(planes: np.ndarray, max_bits: int):
    """K5's model warps over the words: the coder step, then, a chunk of
    STEPS steps at a time, every step's event slots from the ballots of the
    four warps of each group (one barrier a chunk).  Returns (units i32
    [8, cap], counts i32 [8]) as rc_encode_plain does."""
    ctx, bit, act = _words(planes, max_bits)
    G, GW = pwk.GROUPS, pwk.W.GROUP
    cap = GW * (max_bits + 2)
    units = torch.zeros((G, cap), dtype=torch.int32)
    model = _model_rows()
    lanes = torch.arange(pwk.LANES)
    group = lanes // GW
    low = torch.zeros(pwk.LANES, dtype=torch.int64)
    rng = torch.full((pwk.LANES,), 0xFFFFFFFF, dtype=torch.int64)
    live = act[0] if max_bits else torch.zeros(pwk.LANES, dtype=torch.bool)
    live2 = live.view(G, GW).long()
    warm = (2 * (live2.cumsum(1) - live2)).view(-1)
    cursor = 2 * live2.sum(1)
    emitted = torch.zeros(pwk.LANES, dtype=torch.int64)
    slot_a, slot_b = emitted.clone(), emitted.clone()

    def put(ren, unit, slot):
        nonlocal slot_a, slot_b, emitted
        at = torch.where(emitted < 2, warm + emitted, slot_a)
        units[group[ren], at[ren]] = unit[ren].to(torch.int32)
        slot_a = torch.where(ren, slot_b, slot_a)
        slot_b = torch.where(ren, slot, slot_b)
        emitted = emitted + ren.long()

    for c0 in range(0, max_bits, STEPS):
        chunk = []
        for i in range(c0, min(c0 + STEPS, max_bits)):
            p = model[lanes, ctx[i]]
            model[lanes, ctx[i]] = pwk._adapt(p, bit[i])
            low, rng = pwk._rc_split(low, rng, p, bit[i], act[i])
            ren = act[i] & (rng < (1 << 16))
            low, rng, unit = pwk._rc_renorm(low, rng, ren)
            chunk.append((ren, unit))
        for ren, unit in chunk:  # after the chunk's barrier
            r2 = ren.view(G, GW).long()
            slot = (cursor[:, None] + r2.cumsum(1) - r2).view(-1)
            put(ren, unit, slot)
            cursor = cursor + r2.sum(1)
    for _ in range(2):  # the flush: low's high half, then its low half
        put(live, low >> 16, slot_b)
        low = (low << 16) & 0xFFFFFFFF
    return units, cursor.to(torch.int32)


@pytest.mark.parametrize("name", CASES)
def test_model_walk_equals_model_probs_plain(cases, name):
    planes, _, max_bits = cases[name]
    ours = model_walk(planes, max_bits)
    plain = pwk.model_probs_plain(torch.from_numpy(planes), max_bits)
    assert torch.equal(ours, plain)
    if name == "text":  # the JAX model kernel, once in this file
        from libbsc_tpu import api as japi
        from libbsc_tpu.ops import wide_kernels as jwk

        japi.init()
        IT = planes.shape[0] * 4
        ref = jwk._model_call(256, IT, True)(planes.reshape(IT // 4, 8, 128))
        assert np.array_equal(ours.numpy(),
                              np.asarray(ref).reshape(IT, 1024))


@pytest.mark.parametrize("name", CASES)
def test_rc_walk_equals_rc_encode_plain(cases, name):
    planes, sizes, max_bits = cases[name]
    units, counts = rc_walk(planes, max_bits)
    p_units, p_counts = pwk.rc_encode_plain(torch.from_numpy(planes),
                                            max_bits, units.shape[1])
    assert torch.equal(counts, p_counts)
    for g, c in enumerate(counts.tolist()):
        assert torch.equal(units[g, :c], p_units[g, :c])
