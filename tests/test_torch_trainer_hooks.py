"""Port parity of the trainer's hooks
(``train/trainer.py``: ``BestCheckpointer``, ``MemoryStats``,
``TraceProfiler``) and PreciseBN's ``recompute_batch_stats``, on the CPU.

* ``recompute_batch_stats`` on ``HRNET_TINY`` (2 joints) at 32^2 over 4
  seeded batches of 4 (N(2, 3) pixels), from JAX's seeded variables carried
  by ``convert.flax_to_state_dict``: every BN's mean and var within 1e-4 of
  its leaf's scale of JAX's (JAX inverts the EMA, ``(new - 0.9 old) / 0.1``,
  which multiplies its rounding by 10; the port reads each BN's batch
  moments); a second recompute from the new state reproduces the first
  within JAX's own test's bar (rtol 1e-4, atol 1e-5); ``momentum`` is
  ignored; the model keeps its mode. The JAX forward is jitted once.
* ``BestCheckpointer`` and JAX's on the same metric stream and a recording
  manager: the same ``save_best`` / ``save`` calls (the port's at the
  updates done, ``state.step``, where JAX's are at the iteration); and in
  a ``Trainer`` with a real ``CheckpointManager``: ``best/`` holds the best
  step's state.
* ``MemoryStats`` puts nothing without a card, as JAX's puts nothing for
  the CPU device, and ``memory_allocated() / 2^30`` every ``period`` steps
  where there is one (the CUDA calls replaced here).
* ``TraceProfiler`` writes a Chrome trace of exactly its steps, and one of
  what it traced when the run ends before ``stop``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_HRNET_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu.train import trainer as jtrainer
from spacecraft_pose_estimation_tpu.train.optim import build_optimizer as j_build_optimizer
from spacecraft_pose_estimation_tpu.train.state import TrainState as JTrainState
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict, flatten_variables, module_to_flax
from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNET_TINY, HRNet
from spacecraft_pose_estimation_tpu_torch.train import trainer as ttrainer
from spacecraft_pose_estimation_tpu_torch.train.checkpoint import CheckpointManager
from spacecraft_pose_estimation_tpu_torch.train.metrics import MetricStorage
from spacecraft_pose_estimation_tpu_torch.train.optim import build_optimizer
from spacecraft_pose_estimation_tpu_torch.train.state import TrainState

from torch_port_util import few_threads, random_variables, t, to_jax  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def _batches():
    rng = np.random.default_rng(0)
    return [rng.normal(2.0, 3.0, (4, 32, 32, 3)).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def precise_bn():
    jmodel = JHRNet(config=dataclasses.replace(J_HRNET_TINY, num_joints=2))
    variables = random_variables(lambda: jmodel.init(jax.random.key(0), jnp.zeros((4, 32, 32, 3)), train=True), seed=3)
    fwd = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))
    state = JTrainState.create(jmodel, to_jax(variables), j_build_optimizer("adam", 1e-3))
    state = state.replace(apply_fn=lambda v, x, train, mutable: fwd(v, x))
    new = jtrainer.recompute_batch_stats(state, [{"image": jnp.asarray(b)} for b in _batches()])
    want = {k: np.asarray(v) for k, v in flatten_variables({"batch_stats": new.batch_stats}).items()}
    return variables, want


def _port_state(variables):
    model = HRNet(HRNET_TINY.with_joints(2), device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    return TrainState(model, build_optimizer("adam", model.parameters(), 1e-3))


def _stats(model):
    return {k: v for k, v in flatten_variables(module_to_flax(model)).items() if k.startswith("batch_stats/")}


def test_recompute_batch_stats_matches_jax(precise_bn):
    variables, want = precise_bn
    state = _port_state(variables)
    before = _stats(state.model)
    out = ttrainer.recompute_batch_stats(state, [{"image": t(b)} for b in _batches()], momentum=0.5)
    assert out is state and not state.model.training
    got = _stats(state.model)
    assert got.keys() == want.keys() and len(got) > 20
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4 * max(1.0, np.abs(want[k]).max()), err_msg=k)
    assert not np.allclose(got["batch_stats/stem1/bn/mean"], before["batch_stats/stem1/bn/mean"])
    # recomputed from the new state: the same moments (JAX's test_recovers_data_moments)
    ttrainer.recompute_batch_stats(state, [{"image": t(b)} for b in _batches()])
    again = _stats(state.model)
    for k in got:
        np.testing.assert_allclose(again[k], got[k], rtol=1e-4, atol=1e-5, err_msg=k)


class _Manager:
    """Records the hooks' calls; ``save_best`` by the managers' rule (higher)."""

    def __init__(self):
        self.calls, self.best = [], None

    def save_best(self, step, perf, state=None):
        self.calls.append(("save_best", step, perf, state is not None))
        if self.best is None or perf > self.best:
            self.best = perf
            return True
        return False

    def save(self, step, state, metadata=None):
        self.calls.append(("save", step, metadata))


class _Trainer:
    def __init__(self, storage):
        self.storage, self.iteration, self.max_iter = storage, 0, 10
        self.state = type("S", (), {"step": 0})()


STREAM = [None, 0.2, None, 0.5, 0.5, 0.4, 0.9, None, 0.1, 0.9]


@pytest.mark.parametrize("period", [1, 2])
def test_best_checkpointer_calls_match_jax(period):
    from spacecraft_pose_estimation_tpu.train.metrics import MetricStorage as JStorage

    runs = {}
    for name, hook_cls, storage in (("jax", jtrainer.BestCheckpointer, JStorage()),
                                    ("port", ttrainer.BestCheckpointer, MetricStorage())):
        mgr, tr = _Manager(), _Trainer(storage)
        hook = hook_cls(mgr, "bbox/AP", period)
        for i, v in enumerate(STREAM):
            tr.iteration, tr.state.step, storage.step = i, i + 1, i
            if v is not None:
                storage.put_scalar("bbox/AP", v)
            hook.after_step(tr)
        runs[name] = mgr.calls
    shifted = [(c[0], c[1] + 1) + c[2:] for c in runs["jax"]]  # the port saves at the updates done
    assert runs["port"] == shifted and any(c[0] == "save" for c in shifted)


def _counting_step(state, batch):
    with torch.profiler.record_function(f"spe_step_{state.step}"):
        state.model.weight.data += batch
    state.step += 1
    return {"loss": torch.tensor(float(state.step))}


class _State:
    def __init__(self):
        self.model = torch.nn.Linear(2, 2)
        self.step = 0

    def state_dict(self):
        return {"model": self.model.state_dict(), "step": self.step}

    def load_state_dict(self, payload):
        self.model.load_state_dict(payload["model"])
        self.step = payload["step"]


def test_best_checkpointer_keeps_the_best_state(tmp_path):
    # by iteration: best after the second step, the tie is not better; 6 is EvalHook's after_train
    metric = {0: 0.1, 1: 0.6, 2: 0.3, 3: 0.6, 4: 0.2, 6: 0.05}
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=1)
    state, snapshots = _State(), {}

    def evaluate(tr):
        snapshots[tr.state.step] = tr.state.model.weight.detach().clone()
        return {"score": metric[tr.iteration]}

    trainer = ttrainer.Trainer(_counting_step, state, iter([torch.ones(2, 2)] * 6),
                               [ttrainer.EvalHook(1, evaluate), ttrainer.BestCheckpointer(mgr, "score")])
    trainer.train(0, 6)
    assert mgr.best_perf() == 0.6
    with open(tmp_path / "ck" / "best.json") as f:
        assert json.load(f)["step"] == 2
    assert CheckpointManager(str(tmp_path / "ck" / "best")).steps() == [2]
    fresh = _State()
    mgr.restore_best(fresh)
    assert fresh.step == 2 and torch.equal(fresh.model.weight, snapshots[2])


def test_memory_stats_device_rule(monkeypatch):
    from spacecraft_pose_estimation_tpu.train.metrics import MetricStorage as JStorage

    jstorage = JStorage()
    tr = _Trainer(MetricStorage())
    hook = ttrainer.MemoryStats(period=2)
    for i in range(4):
        tr.iteration = i
        hook.after_step(tr)
    if not torch.cuda.is_available():
        assert "device_mem_gb" not in tr.storage.latest()  # no card: nothing, as JAX for the CPU device
        jtr = _Trainer(jstorage)
        jtrainer.MemoryStats(period=1).after_step(jtr)
        assert "device_mem_gb" not in jstorage.latest()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda: 3 * 2**30 + 2**29)
    tr = _Trainer(MetricStorage())
    for i in range(4):
        tr.iteration = tr.storage.step = i
        hook.after_step(tr)
    assert tr.storage.latest()["device_mem_gb"] == (3.5, 3)
    assert len(tr.storage._history["device_mem_gb"]) == 2  # after steps 1 and 3


def _trace_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_profiler_traces_its_steps(tmp_path):
    hook = ttrainer.TraceProfiler(str(tmp_path / "prof"), start=1, stop=2)
    ttrainer.Trainer(_counting_step, _State(), iter([torch.ones(2, 2)] * 5), [hook]).train(0, 5)
    names = _trace_names(hook.path)
    assert {"spe_step_1", "spe_step_2"} <= names and not {"spe_step_0", "spe_step_3"} & names
    # a run that ends before stop: the trace of what ran
    early = ttrainer.TraceProfiler(str(tmp_path / "early"), start=2, stop=9)
    ttrainer.Trainer(_counting_step, _State(), iter([torch.ones(2, 2)] * 4), [early]).train(0, 4)
    assert os.path.basename(early.path) == "trace_2-9.json"
    assert {"spe_step_2", "spe_step_3"} <= _trace_names(early.path)
