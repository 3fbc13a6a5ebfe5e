"""The port's device-state re-shard (``train/reshard.py``) and the elastic
workload's record helpers against the JAX package, with no process.

- The row update and its momentum, row by row over 900 positions at two
  seeds, bitwise equal to JAX's jitted ``make_row_update``;
  ``expected_params`` gives JAX's digest; a single-rounding multiply-add
  (what a fused form computes) does not.
- The row store: rows written by either package read back by the other,
  the files byte for byte the same.
- ``rebuild_state`` on the same store and fresh set: JAX's counts,
  authoritative set and arrays, bitwise, for nothing fresh, all fresh, a
  mix, rows missing from the store, a leftover ``.tmp-*`` file and a
  store row of the wrong width; ``assemble_final`` likewise.
- ``_deal``, ``_digest`` and ``_read_records`` (a torn last line
  included) against ``workloads/elastic.py``'s.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tf_operator_tpu.train import reshard as JR  # noqa: E402
from tf_operator_tpu.train.data import elastic_global_order  # noqa: E402
from tf_operator_tpu.workloads import elastic as JE  # noqa: E402
from tf_operator_tpu_torch.train import reshard as TR  # noqa: E402
from tf_operator_tpu_torch.workloads import elastic as TE  # noqa: E402

torch.set_num_threads(1)

ROWS = 900  # the soak's default corpus
SEEDS = (0, 12)
# the uninterrupted run's params digest at the soak's defaults, seed 12
# (900 windows; the JAX package's expected_params)
SEED12_DIGEST = "0638262822466a93"


def test_constants_match():
    assert (TR.PARAM_DIM, TR.ROW_DECAY, TR.ROW_LR) == (JR.PARAM_DIM, JR.ROW_DECAY, JR.ROW_LR)
    for p in (0, 1, 899):
        assert TR.init_row(5, p).tobytes() == JR.init_row(5, p).tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_row_update_bitwise_every_position(seed):
    order = elastic_global_order(ROWS, seed=seed)
    jupdate = JR.make_row_update()
    jzero = jnp.zeros((), jnp.float32)
    tzero = torch.zeros((), dtype=torch.float32)
    for p in range(ROWS):
        base = JR.init_row(seed, p)
        w = float(int(order[p]))
        jrow, jmom = jupdate(jnp.asarray(base), jzero, jnp.asarray(w, jnp.float32))
        trow, tmom = TR.row_update(torch.from_numpy(base), tzero,
                                   torch.tensor(w, dtype=torch.float32))
        assert trow.numpy().tobytes() == np.asarray(jrow).tobytes(), p
        assert tmom.numpy().tobytes() == np.asarray(jmom).tobytes(), p


@pytest.mark.parametrize("seed", SEEDS)
def test_expected_params_digest_is_jax_s(seed):
    order = elastic_global_order(ROWS, seed=seed)
    want = JR.params_digest(JR.expected_params(ROWS, JR.PARAM_DIM, seed, order))
    got = TR.params_digest(TR.expected_params(ROWS, TR.PARAM_DIM, seed, order, device="cpu"))
    assert got == want
    if seed == 12:
        assert got.startswith(SEED12_DIGEST)


def test_single_rounding_multiply_add_changes_the_digest():
    """What a fused multiply-add computes (ROW_DECAY * row + ROW_LR * w
    rounded once; exact here in f64) moves some rows' bits, so the
    params digest catches the wrong form."""
    seed = 12
    order = elastic_global_order(ROWS, seed=seed)
    lr = np.float64(np.float32(TR.ROW_LR))
    fused = np.stack([
        (TR.ROW_DECAY * TR.init_row(seed, p).astype(np.float64)
         + lr * np.float64(order[p])).astype(np.float32) for p in range(ROWS)])
    want = TR.expected_params(ROWS, TR.PARAM_DIM, seed, order, device="cpu")
    assert (fused != want).any()
    assert TR.params_digest(fused) != TR.params_digest(want)


def test_row_store_reads_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    a, b = tmp_path / "a", tmp_path / "b"
    for p in range(6):
        row = rng.standard_normal(TR.PARAM_DIM).astype(np.float32)
        mom = float(np.float32(rng.standard_normal()))
        TR.write_row(str(a), p, row, mom)
        JR.write_row(str(b), p, row, mom)
        assert TR.row_path(str(a), p)[len(str(a)):] == JR.row_path(str(b), p)[len(str(b)):]
        assert open(TR.row_path(str(a), p), "rb").read() == \
            open(JR.row_path(str(b), p), "rb").read()
        for mine, theirs in ((TR.read_row(str(b), p), JR.read_row(str(b), p)),
                             (JR.read_row(str(a), p), TR.read_row(str(a), p))):
            assert mine[0].tobytes() == theirs[0].tobytes() and mine[1] == theirs[1]
    assert TR.state_dir("/w") == JR.state_dir("/w")
    assert TR.read_row(str(a), 99) is None and JR.read_row(str(a), 99) is None


TOTAL, SEED = 64, 3


def _store(sdir, rows, seed=SEED):
    """Publish ``rows`` (the soak's update of each) into the store."""
    order = elastic_global_order(TOTAL, seed=seed)
    for p in rows:
        row = (TR.ROW_DECAY * torch.from_numpy(TR.init_row(seed, p))
               + TR.ROW_LR * torch.tensor(float(order[p]))).numpy()
        TR.write_row(sdir, p, row, float(np.float32(TR.ROW_LR * order[p])))


def _device_copy(seed=SEED):
    """A member's current device state: every row some value of its own."""
    rng = np.random.default_rng(seed + 100)
    return (rng.standard_normal((TOTAL, TR.PARAM_DIM)).astype(np.float32),
            rng.standard_normal(TOTAL).astype(np.float32))


def _case(name, sdir):
    evens, odds = set(range(0, TOTAL, 2)), set(range(1, TOTAL, 2))
    if name == "nothing_fresh":
        _store(sdir, range(0, TOTAL, 3))
        return set()
    if name == "all_fresh":
        _store(sdir, range(TOTAL))
        return set(range(TOTAL))
    if name == "mixed":
        _store(sdir, odds)
        return evens | {1, 3}
    if name == "rows_missing":
        _store(sdir, [p for p in odds if p % 5])
        return {0, 2, 4}
    if name == "leftover_tmp":
        _store(sdir, odds)
        # a member killed mid-write leaves its tmp file, never the row
        with open(TR.row_path(sdir, 10) + ".tmp-4242", "wb") as f:
            np.save(f, np.ones(TR.PARAM_DIM + 1, np.float32))
        with open(TR.row_path(sdir, 11) + ".tmp-4243", "wb") as f:
            f.write(b"torn")
        return {0, 2}
    if name == "wrong_width":
        _store(sdir, odds)
        with open(TR.row_path(sdir, 7), "wb") as f:
            np.save(f, np.ones(TR.PARAM_DIM + 3, np.float32))
        return {0}
    raise KeyError(name)


@pytest.mark.parametrize("name", ["nothing_fresh", "all_fresh", "mixed", "rows_missing",
                                  "leftover_tmp", "wrong_width"])
def test_rebuild_state_matches_jax(tmp_path, name):
    sdir = str(tmp_path / "state")
    os.makedirs(sdir)
    fresh = _case(name, sdir)
    params, mom = _device_copy()
    sharding = JR.replicated_sharding(JR.local_mesh())
    jp, jm, jplan = JR.rebuild_state(TOTAL, JR.PARAM_DIM, SEED, sdir, jnp.asarray(params),
                                     jnp.asarray(mom), set(fresh), sharding, epoch=4)
    tp, tm, tplan = TR.rebuild_state(TOTAL, TR.PARAM_DIM, SEED, sdir,
                                     torch.from_numpy(params), torch.from_numpy(mom),
                                     set(fresh), "cpu", epoch=4)
    assert (tplan.relaid, tplan.refetched, tplan.inited, tplan.epochs) == \
        (jplan.relaid, jplan.refetched, jplan.inited, jplan.epochs)
    assert tplan.authoritative == jplan.authoritative
    assert tplan.relaid == len(fresh)
    assert tp.numpy().tobytes() == np.asarray(jp).tobytes()
    assert tm.numpy().tobytes() == np.asarray(jm).tobytes()
    assert TR.assemble_final(TOTAL, TR.PARAM_DIM, SEED, sdir).tobytes() == \
        JR.assemble_final(TOTAL, JR.PARAM_DIM, SEED, sdir).tobytes()
    # a member with no device state (a re-grown join) rebuilds from the
    # store alone, as JAX's does
    jp0, _, jplan0 = JR.rebuild_state(TOTAL, JR.PARAM_DIM, SEED, sdir, None, None, set(),
                                      sharding)
    tp0, _, tplan0 = TR.rebuild_state(TOTAL, TR.PARAM_DIM, SEED, sdir, None, None, set(),
                                      "cpu")
    assert (tplan0.refetched, tplan0.inited, tplan0.authoritative) == \
        (jplan0.refetched, jplan0.inited, jplan0.authoritative)
    assert tp0.numpy().tobytes() == np.asarray(jp0).tobytes()


def test_plan_merge_and_split_match():
    fresh = {1, 5, 9}
    assert TR.plan_rows(12, fresh) == JR.plan_rows(12, fresh)
    a, b = TR.ReshardPlan(1, 2, 3, [0]), JR.ReshardPlan(1, 2, 3, [0])
    a.merge(TR.ReshardPlan(4, 5, 6, [1]))
    b.merge(JR.ReshardPlan(4, 5, 6, [1]))
    assert (a.relaid, a.refetched, a.inited, a.epochs) == (b.relaid, b.refetched, b.inited,
                                                          b.epochs)


def test_deal_digest_and_records_match(tmp_path):
    members = ["j-worker-0", "j-worker-2", "j-worker-1"]
    remaining = [3, 4, 7, 8, 9, 11, 20]
    assert TE._deal(remaining, members) == JE._deal(remaining, members)
    order = elastic_global_order(40, seed=2)
    recs = [{"p": p, "w": int(order[p])} for p in (5, 1, 1, 30, 0)]
    assert TE._digest(recs, 40) == JE._digest(recs, 40)
    # the file format: one JSON object a line, a member a file; the last
    # line of one torn mid-append
    lines = [json.dumps({"p": p, "w": int(order[p]), "t": 0.0, "m": "a", "e": 0})
             for p in range(4)]
    (tmp_path / "consumed-a.jsonl").write_text("\n".join(lines) + "\n")
    (tmp_path / "consumed-b.jsonl").write_text(lines[0] + "\n\n" + '{"p": 9, "w"')
    (tmp_path / "other.jsonl").write_text(lines[1] + "\n")
    got, want = TE._read_records(str(tmp_path)), JE._read_records(str(tmp_path))
    assert got == want and len(got) == 5
    assert TE._digest(got, 40) == JE._digest(want, 40)
