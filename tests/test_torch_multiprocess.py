"""The port's training over several processes, end to end: the counterparts
of ``tests/test_multiprocess.py`` and ``tests/test_multiprocess_tp_resume.py``
(marked ``slow`` as they are). The ranks are child processes over gloo on
the CPU (``tests/torch_parallel_worker.py``), launched with ``torchrun``'s
variables; they import torch and the port only.
"""

import numpy as np
import pytest
import torch

from torch_parallel_worker import Ranks
from vision_collision_detection_tpu_torch.media.synthetic import (
    generate_dataset,
)


def _synthetic(tmp_path):
    return generate_dataset(
        str(tmp_path / "synth"), clips_per_class=6, num_frames=8, height=40,
        width=56, splits=("train", "train", "train", "train", "val", "test"))


def _load(tmp_path, tag, world):
    return [torch.load(tmp_path / f"{tag}_r{r}.pt", weights_only=True)
            for r in range(world)]


@pytest.mark.slow
def test_two_process_trainer_over_a_shared_run_dir(tmp_path):
    """``Trainer`` + ``DataParallelStrategy`` on two processes: the gathered
    test metrics are the same on both, the 3 test clips come back once
    each with their rows aligned, no pad leaks."""
    csv = _synthetic(tmp_path)
    Ranks("trainer", 2, tmp_path, tmp_path,
          {"VCD_CSV": str(csv)}).wait(timeout=1200)
    r0, r1 = _load(tmp_path, "trainer", 2)
    assert r0["loss"] == r1["loss"] and np.isfinite(r0["loss"])
    assert r0["accuracy"] == r1["accuracy"]
    assert r0["num_samples"] == r1["num_samples"] == 3
    assert r0["ids"] == r1["ids"] and len(set(r0["ids"])) == 3
    assert all("__pad__" not in i for i in r0["ids"])
    assert r0["preds"] == r1["preds"] and r0["targets"] == r1["targets"]


@pytest.mark.slow
def test_four_process_data_and_tensor_parallel_steps(tmp_path):
    """A 2 × 2 mesh: three SGD steps of vivit_tiny clipped at a global
    norm of 1, the batch split over the data group and the heads over the
    model group, against one device on the whole batch (loss and norm rel
    1e-4, parameters rtol 1e-4 / atol 1e-6); all four ranks agree."""
    Ranks("dptp", 4, tmp_path, tmp_path,
          {"VCD_NUM_MODEL": "2"}).wait(timeout=1200)
    res = _load(tmp_path, "dptp", 4)
    assert [r["mesh"] for r in res] == [(2, 2, 0, 0), (2, 2, 0, 1),
                                        (2, 2, 1, 0), (2, 2, 1, 1)]
    assert res[0]["local_query"] == (32, 64)
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]
        for k, v in res[0]["params"].items():
            assert torch.equal(r["params"][k], v), k
    for got, want in zip(res[0]["metrics"], res[0]["single_metrics"]):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
    for k, v in res[0]["single_params"].items():
        np.testing.assert_allclose(res[0]["params"][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.slow
def test_two_process_kill_and_resume_is_bit_equal(tmp_path):
    """An uninterrupted 2-epoch run; a run whose processes kill themselves
    right after the epoch-0 ``last`` checkpoint; fresh processes resuming
    it: the final parameters are bit-equal to the uninterrupted run's, on
    both processes."""
    base = {"VCD_CSV": str(_synthetic(tmp_path))}
    Ranks("resume", 2, tmp_path, tmp_path,
          dict(base, VCD_RUN="run_a", VCD_TAG="a")).wait(timeout=1200)
    Ranks("resume", 2, tmp_path, tmp_path,
          dict(base, VCD_RUN="run_b", VCD_TAG="b_dead",
               VCD_DIE_AFTER_SAVE="1")).wait(timeout=1200, expect_rc=9)
    assert not (tmp_path / "b_dead_r0.pt").exists()
    Ranks("resume", 2, tmp_path, tmp_path,
          dict(base, VCD_RUN="run_b", VCD_TAG="b",
               VCD_RESUME="1")).wait(timeout=1200)
    a0, a1 = _load(tmp_path, "a", 2)
    b0, b1 = _load(tmp_path, "b", 2)
    assert a0["params_sha"] == a1["params_sha"]
    assert b0["params_sha"] == b1["params_sha"]
    assert b0["params_sha"] == a0["params_sha"]
    assert b0["final_step"] == a0["final_step"]
    assert b0["start_epoch"] == 1 and a0["start_epoch"] == 0
