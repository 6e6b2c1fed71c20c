"""The ranks of the port's data- and tensor-parallel tests: child processes
over gloo on the CPU, launched with ``torchrun``'s variables by ``Ranks``.

    python tests/torch_parallel_worker.py SUITE IN_DIR OUT_DIR

Each suite runs every check of one test file in one process group and
writes ``OUT_DIR/SUITE_r{rank}.pt`` (``VCD_TAG`` in place of the suite
where set; tensors, numbers and strings, loaded
with ``weights_only=True``); the test functions assert on those files.
The children import torch and the port only, never JAX: the weights come
from the JAX package through the bridge (``from_flax_params``), written by
the test as ``IN_DIR/<name>.npz``, beside the inputs in ``IN_DIR/data.npz``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """``world_size`` ranks of ``suite``, started at once; ``wait`` joins
    them (the caller can compute its references meanwhile)."""

    def __init__(self, suite: str, world_size: int, in_dir, out_dir,
                 extra_env: Optional[Dict[str, str]] = None):
        port = _free_port()
        self.procs = []
        for rank in range(world_size):
            env = dict(os.environ, RANK=str(rank),
                       WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       PYTHONPATH=REPO, **(extra_env or {}))
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), suite,
                 str(in_dir), str(out_dir)], env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))

    def wait(self, timeout: float = 600, expect_rc: int = 0) -> List[str]:
        """Every rank must exit with ``expect_rc`` within ``timeout``
        seconds (the rest are killed). → the ranks' outputs."""
        try:
            outs = [p.communicate(timeout=timeout)[0].decode()
                    for p in self.procs]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, out) in enumerate(zip(self.procs, outs)):
            assert p.returncode == expect_rc, (
                f"rank {rank} exited {p.returncode} (wanted {expect_rc}):\n"
                f"{out[-4000:]}")
        return outs


# ---- the ranks ------------------------------------------------------------

def _load_sd(in_dir, name):
    import numpy as np
    import torch

    with np.load(os.path.join(in_dir, f"{name}.npz")) as f:
        return {k: torch.from_numpy(f[k]) for k in f.files}


def _sd_copy(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _ln_vivit():
    """The JAX tests' LayerNorm ViViT (``tests/test_parallel.py:85-94``):
    dim 32, one spatial and one temporal block, 4 heads, patch 8, float32,
    for 32² frames."""
    import torch

    from vision_collision_detection_tpu_torch.models.vivit import ViViT

    return ViViT(num_patches=16, dim=32, spatial_layers=1, temporal_layers=1,
                 num_heads=4, patch_size=8, num_classes=3,
                 dtype=torch.float32)


def _sgd_state(model, lr):
    """optax.sgd(lr) without momentum, a constant rate."""
    import torch

    from vision_collision_detection_tpu_torch.train import TrainState

    return TrainState(torch.optim.SGD(model.parameters(), lr=lr),
                      lambda step: lr)


def _step_once(step, state, frames, targets, mask, sensor=None, seed=99):
    import torch

    kw = {} if sensor is None else {"sensor": sensor}
    _, m = step(state, frames, targets, mask,
                torch.Generator().manual_seed(seed), **kw)
    return {k: float(v) for k, v in m.items()}


def _bn_config(**over):
    """The JAX DP tests' ``tiny_config`` (``tests/test_parallel.py:26-38``)
    with SGD: resnet18 + pooling, float32, 4 frames of 32²."""
    from vision_collision_detection_tpu_torch.config import ExperimentConfig

    return ExperimentConfig().override({
        "model.backbone": "resnet18", "model.temporal_mode": "pooling",
        "model.dtype": "float32", "model.dropout": 0.0, "data.fps": 4,
        "data.duration": 1, "data.frame_size": 32, "data.batch_size": 2,
        "augment.blur_sigma": 0.0, "augment.enabled": False,
        "augment.horizontal_flip_prob": 0.0, "optim.optimizer": "sgd",
        **over})


def suite_dp(in_dir, out_dir, rank, mesh):
    """The checks of ``tests/test_torch_parallel.py``."""
    import numpy as np
    import torch

    from vision_collision_detection_tpu_torch.parallel import (
        DataParallelStrategy,
    )
    from vision_collision_detection_tpu_torch.train import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    data = dict(np.load(os.path.join(in_dir, "data.npz")))
    out = {}
    dp = DataParallelStrategy(mesh)
    n = dp.num_data_shards
    out["shard"] = (dp.num_data_shards, dp.data_shard_index,
                    dp.local_device_count, dp.pad_batches, dp.is_main)

    def mine(a):
        a = torch.from_numpy(np.ascontiguousarray(a))
        return a.chunk(n)[rank]

    # 1. the LayerNorm ViViT: the 2-rank step, and on rank 0 the step of one
    # device on the concatenated batch
    from vision_collision_detection_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig().override({
        "model.dtype": "float32", "model.dropout": 0.0, "data.fps": 4,
        "data.duration": 1, "data.frame_size": 32, "augment.enabled": False,
        "augment.horizontal_flip_prob": 0.0, "augment.blur_sigma": 0.0})
    ln_sd = _load_sd(in_dir, "ln")
    frames, targets, mask = (data["ln_frames"], data["ln_targets"],
                             data["ln_mask"])
    model = _ln_vivit()
    model.load_state_dict(ln_sd)
    state = _sgd_state(model, 1e-4)
    step, _ = dp.make_steps(model, cfg, None)
    out["ln_dp_metrics"] = _step_once(step, state, mine(frames),
                                      mine(targets), mine(mask))
    out["ln_dp_params"] = _sd_copy(model)
    if rank == 0:
        single = _ln_vivit()
        single.load_state_dict(ln_sd)
        out["ln_single_metrics"] = _step_once(
            make_train_step(single, cfg), _sgd_state(single, 1e-4),
            torch.from_numpy(frames), torch.from_numpy(targets),
            torch.from_numpy(mask))
        out["ln_single_params"] = _sd_copy(single)

    # the fault the sum hook repairs: DDP's own hook, which averages
    class Averaging(DataParallelStrategy):
        def wrap(self, model):
            dev = next(model.parameters()).device
            return torch.nn.parallel.DistributedDataParallel(
                model, device_ids=[dev.index] if dev.type == "cuda" else None,
                process_group=self.mesh.data_group, broadcast_buffers=False)

    model = _ln_vivit()
    model.load_state_dict(ln_sd)
    step, _ = Averaging(mesh).make_steps(model, cfg, None)
    _step_once(step, _sgd_state(model, 1e-4), mine(frames), mine(targets),
               mine(mask))
    out["ln_avg_params"] = _sd_copy(model)

    # 2. resnet18 (BatchNorm) with pooling, SGD from the config; the ranks'
    # own single-device updates of their shards for the statistics' mean
    cfg = _bn_config()
    r18_sd = _load_sd(in_dir, "r18")
    frames, targets, mask = (data["bn_frames"], data["bn_targets"],
                             data["bn_mask"])
    model, state = create_train_state(cfg, torch.Generator().manual_seed(0),
                                      10, device="cpu")
    model.load_state_dict(r18_sd)
    step, eval_step = dp.make_steps(model, cfg, None)
    out["bn_dp_metrics"] = _step_once(step, state, mine(frames),
                                      mine(targets), mine(mask))
    out["bn_dp_state"] = _sd_copy(model)
    own, own_state = create_train_state(cfg, torch.Generator().manual_seed(0),
                                        10, device="cpu")
    own.load_state_dict(r18_sd)
    _step_once(make_train_step(own, cfg), own_state, mine(frames),
               mine(targets), mine(mask))
    out["bn_own_state"] = _sd_copy(own)

    # 3. the evaluation: each rank its shard, the probabilities gathered
    frames, targets, mask = (data["ev_frames"], data["ev_targets"],
                             data["ev_mask"])
    model.load_state_dict(r18_sd)
    ev = eval_step(mine(frames), mine(targets), mine(mask))
    gathered = dp.gather_eval({"probs": ev["probs"].numpy(),
                               "preds": ev["preds"].numpy(),
                               "pad": np.zeros(len(ev["preds"]), bool)})
    out["ev_loss"] = float(ev["loss"])
    out["ev_probs"] = torch.from_numpy(gathered["probs"])
    out["ev_pad"] = torch.from_numpy(gathered["pad"])
    if rank == 0:
        ref = make_eval_step(model, cfg)(torch.from_numpy(frames),
                                         torch.from_numpy(targets),
                                         torch.from_numpy(mask))
        out["ev_single_loss"] = float(ref["loss"])
        out["ev_single_probs"] = ref["probs"].clone()

    # 4. the sensor branch, sharded with the batch, from the JAX weights
    cfg = _bn_config(**{"model.use_sensor": True, "model.frame_subsample": 1,
                        "data.load_sensor_data": True})
    frames, targets, mask, sensor = (data["bn_frames"], data["bn_targets"],
                                     data["bn_mask"], data["sensor"])
    model, state = create_train_state(cfg, torch.Generator().manual_seed(0),
                                      10, device="cpu")
    model.load_state_dict(_load_sd(in_dir, "r18_sensor"))
    step, eval_step = dp.make_steps(model, cfg, None)
    out["sensor_dp_metrics"] = _step_once(step, state, mine(frames),
                                          mine(targets), mine(mask),
                                          sensor=mine(sensor))
    out["sensor_dp_state"] = _sd_copy(model)
    ev = eval_step(mine(frames), mine(targets), mine(mask),
                   sensor=mine(sensor))
    out["sensor_probs"] = ev["probs"].clone()

    # 5. the Trainer: one epoch and test() over a shared run directory
    out.update(_dp_trainer(in_dir, out_dir, rank, dp))
    return out


def _dp_trainer(in_dir, out_dir, rank, strategy):
    """One epoch of ``Trainer`` with ``strategy`` over stand-in datasets of
    8 training, 4 validation and 3 test clips (vivit_tiny at 28², one clip
    per device a step), then ``test()``; each rank counts the checkpoint
    files it wrote."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke
    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.parallel import (
        sync_global_devices,
    )
    from vision_collision_detection_tpu_torch.train import Trainer

    g = np.random.default_rng(0)

    def ds(n):
        clips = g.integers(0, 256, (n, 2, 16, 28, 3), dtype=np.uint8)
        return chip_smoke.StandInClips(clips, None, labels=np.arange(n) % 3)

    train, val, test = ds(8), ds(4), ds(3)
    cfg = ExperimentConfig().override({
        "model.backbone": "vivit_tiny", "model.patch_size": 14,
        "model.dtype": "float32", "data.frame_size": 28, "data.fps": 2,
        "data.duration": 1, "data.batch_size": 1, "data.num_workers": 1,
        "train.epochs": 1, "train.validation_freq": 0,
        "train.log_every_steps": 0, "train.dashboard": False,
        "train.checkpoint_every_epochs": 0,
        "augment.enabled": False, "augment.horizontal_flip_prob": 0.0,
        "augment.blur_sigma": 0.0})
    writes = [0]
    save = torch.save

    def counted_save(*args, **kwargs):
        writes[0] += 1
        return save(*args, **kwargs)

    torch.save = counted_save
    run_dir = os.path.join(out_dir, "run_shared")
    tr = Trainer(cfg, train, val, test, run_dir=run_dir, strategy=strategy,
                 device="cpu")
    tr.train()
    res = tr.test()
    torch.save = save
    sync_global_devices("tested")  # rank 0's artifacts are all written
    return {"tr_batch_size": tr.train_loader.batch_size,
            "tr_steps": tr.steps_per_epoch,
            "tr_num_samples": int(res["num_samples"]),
            "tr_loss": float(res["loss"]), "tr_ids": list(res["ids"]),
            "tr_preds": torch.as_tensor(res["_preds"]),
            "tr_writes": writes[0],
            "tr_roles": sorted(r for r in ("best", "last")
                               if tr.store.exists(r)),
            "tr_files": sorted(os.listdir(run_dir))}


def _tp_vivit(impl="xla", dtype=None):
    """vivit_small's widths (dim 384, 6 heads of 64, MLP 1536) cut to two
    spatial blocks and one temporal one, patch 8 on 16² frames."""
    import torch

    from vision_collision_detection_tpu_torch.models.vivit import ViViT

    return ViViT(num_patches=4, dim=384, spatial_layers=2, temporal_layers=1,
                 num_heads=6, patch_size=8, num_classes=3,
                 dtype=dtype or torch.float32, attention_impl=impl)


def suite_tp(in_dir, out_dir, rank, mesh):
    """The checks of ``tests/test_torch_tp.py``: model size 2."""
    import numpy as np
    import torch

    from vision_collision_detection_tpu_torch.ckpt import CheckpointStore
    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.parallel import (
        ModelParallelStrategy,
    )
    from vision_collision_detection_tpu_torch.parallel.tp import (
        full_state_dict,
        shard_state_dict,
    )
    from vision_collision_detection_tpu_torch.train import (
        TrainState,
        make_eval_step,
        make_train_step,
    )

    data = dict(np.load(os.path.join(in_dir, "data.npz")))
    frames, targets, mask = (torch.from_numpy(data["frames"]),
                             torch.from_numpy(data["targets"]),
                             torch.from_numpy(data["mask"]))
    sd = _load_sd(in_dir, "vivit")
    cfg = ExperimentConfig().override({
        "model.dtype": "float32", "model.dropout": 0.0, "data.fps": 2,
        "data.duration": 1, "data.frame_size": 16, "augment.enabled": False,
        "augment.horizontal_flip_prob": 0.0, "augment.blur_sigma": 0.0})
    out = {}

    # 1. one TP step (SGD 1e-3) from the bridged weights, gathered
    tp = ModelParallelStrategy(mesh)
    model = _tp_vivit()
    model.load_state_dict(sd)
    state = tp.shard_state(model, _sgd_state(model, 1e-3))
    out["rules"] = dict(tp.rules)
    out["local_query"] = tuple(model.spatial_0.attn.query.weight.shape)
    step, eval_step = tp.make_steps(model, cfg, None)
    out["tp_metrics"] = _step_once(step, state, frames, targets, mask, seed=3)
    full, _ = tp.full_state(model, state.optimizer)
    out["tp_params"] = full
    # 2. the evaluation after it, against one device with the gathered
    # weights
    ev = eval_step(frames, targets, mask)
    out["tp_eval_probs"] = ev["probs"].clone()
    out["tp_eval_loss"] = float(ev["loss"])
    single = _tp_vivit()
    single.load_state_dict(full)
    ref = make_eval_step(single, cfg)(frames, targets, mask)
    out["single_eval_probs"] = ref["probs"].clone()
    out["single_eval_loss"] = float(ref["loss"])

    # 3. full_state_dict(shard_state_dict(sd)) on the bridged weights
    back = full_state_dict(shard_state_dict(sd, tp.rules, mesh.model_index,
                                            mesh.n_model), tp.rules,
                           mesh.model_group, mesh.n_model)
    out["roundtrip_equal"] = sorted(back) == sorted(sd) and all(
        torch.equal(back[k], sd[k]) for k in sd)

    # 4. AdamW's moments on the local shards: one step of one device, then
    # the state cut; one TP step more, and the moments gathered back
    model = _tp_vivit()
    model.load_state_dict(sd)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, eps=1e-8,
                            weight_decay=1e-4)
    state = TrainState(opt, lambda s: 1e-3, 1.0)
    _step_once(make_train_step(model, cfg), state, frames, targets, mask)
    names = [n for n, _ in model.named_parameters()]
    full_moments = {n: {k: v.clone() for k, v in opt.state[p].items()}
                    for n, p in model.named_parameters()}
    tp2 = ModelParallelStrategy(mesh)
    state = tp2.shard_state(model, state)
    cut_ok = []
    for n, p in model.named_parameters():
        s = state.optimizer.state[p]
        for k in ("exp_avg", "exp_avg_sq"):
            want = full_moments[n][k]
            if n in tp2.rules:
                want = want.chunk(mesh.n_model, tp2.rules[n])[
                    mesh.model_index]
            cut_ok.append(torch.equal(s[k], want))
        cut_ok.append(torch.equal(s["step"], full_moments[n]["step"]))
    out["moments_cut_equal"] = all(cut_ok)
    step2, _ = tp2.make_steps(model, cfg, None)
    out["adamw_metrics"] = _step_once(step2, state, frames, targets, mask)
    out["moment_shapes"] = {
        n: tuple(state.optimizer.state[p]["exp_avg"].shape)
        for n, p in model.named_parameters()}
    _, opt_sd = tp2.full_state(model, state.optimizer)
    out["gathered_moment_shapes"] = {
        names[i]: tuple(s["exp_avg"].shape)
        for i, s in opt_sd["state"].items()}

    # 5. a checkpoint of the TP model (rank 0 writes the gathered tensors)
    # and the TP forward it must reproduce on one device
    model = _tp_vivit()
    model.load_state_dict(sd)
    tp3 = ModelParallelStrategy(mesh)
    state = tp3.shard_state(model, _sgd_state(model, 1e-3))
    model_sd, opt_sd = tp3.full_state(model, state.optimizer)
    CheckpointStore(os.path.join(out_dir, "tp_run")).save(
        "best", arrays={"model": model_sd, "optimizer": opt_sd, "step": 0},
        meta={})
    with torch.no_grad():
        out["tp_forward"] = model.eval()(frames.float() / 255.0)
    # the fault the design avoids: the out projection's bias added on every
    # rank before the sum
    def bias_before_sum(self, o):
        B, S = o.shape[:2]
        return self.tp.exit(torch.nn.functional.linear(
            o.reshape(B, S, -1), self.out.weight, self.out.bias))

    attn_cls = type(model.spatial_0.attn)
    good = attn_cls.project_out
    attn_cls.project_out = bias_before_sum
    try:
        with torch.no_grad():
            out["tp_forward_bias_fault"] = model(frames.float() / 255.0)
    finally:
        attn_cls.project_out = good
    # 6. the "flash" blocks (K4's plain version here) on the local heads
    flash = _tp_vivit("flash")
    flash.load_state_dict(sd)
    ModelParallelStrategy(mesh).shard_state(flash, _sgd_state(flash, 1e-3))
    with torch.no_grad():
        out["tp_flash_forward"] = flash.eval()(frames.float() / 255.0)
    return out


def _synthetic_splits(frame_size=32):
    """The JAX multi-process tests' datasets: ``IN_DIR``'s synthetic clips
    (``VCD_CSV``) split into train, val and test."""
    import pandas as pd

    from vision_collision_detection_tpu_torch.data import (
        create_datasets_with_manual_split,
    )

    df = pd.read_csv(os.environ["VCD_CSV"]).fillna({"sensor_path": ""})
    return create_datasets_with_manual_split(df, fps=4, duration=1,
                                             frame_size=frame_size)


def suite_trainer(in_dir, out_dir, rank, mesh):
    """``tests/test_multiprocess.py``'s worker: ``Trainer`` with
    ``DataParallelStrategy`` on two processes over one shared run
    directory, resnet18 + pooling on decoded synthetic clips, one epoch,
    ``test()``."""
    from vision_collision_detection_tpu_torch.parallel import (
        DataParallelStrategy,
    )
    from vision_collision_detection_tpu_torch.train import Trainer

    train, val, test = _synthetic_splits()
    cfg = _bn_config(**{"data.batch_size": 2, "data.num_workers": 2,
                        "optim.optimizer": "adamw", "train.epochs": 1,
                        "train.validation_freq": 0,
                        "train.log_every_steps": 0,
                        "train.dashboard": False})
    tr = Trainer(cfg, train, val, test,
                 run_dir=os.path.join(out_dir, "run_shared"),
                 strategy=DataParallelStrategy(mesh), device="cpu")
    tr.train()
    res = tr.test()
    return {"loss": float(res["loss"]), "accuracy": float(res["accuracy"]),
            "num_samples": int(res["num_samples"]), "ids": list(res["ids"]),
            "preds": [int(p) for p in res["_preds"]],
            "targets": [int(t) for t in res["_targets"]]}


def suite_dptp(in_dir, out_dir, rank, mesh):
    """DP×TP on a 2 × 2 mesh (``tests/test_multiprocess_tp_resume.py``'s
    TP worker): vivit_tiny (4 heads, 2 a rank), the batch of 4 clips split
    over the data group, three SGD steps (momentum 0.9) clipped at a global
    norm of 1; on rank 0 the same steps of one device on the whole
    batch."""
    import numpy as np
    import torch

    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.parallel import (
        ModelParallelStrategy,
    )
    from vision_collision_detection_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    cfg = ExperimentConfig().override({
        "model.backbone": "vivit_tiny", "model.patch_size": 8,
        "model.dtype": "float32", "model.dropout": 0.0, "data.fps": 2,
        "data.duration": 1, "data.frame_size": 32,
        "optim.optimizer": "sgd", "optim.grad_clip_norm": 1.0,
        "optim.learning_rate": 1e-3,
        "augment.enabled": False, "augment.horizontal_flip_prob": 0.0,
        "augment.blur_sigma": 0.0})
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(
        (rng.random((4, 2, 32, 32, 3)) * 255).astype(np.uint8))
    targets = torch.arange(4) % 3
    mask = torch.ones(4)

    def run(model, state, step, part):
        losses = []
        for i in range(3):
            losses.append(_step_once(step, state, part(frames),
                                     part(targets), part(mask), seed=i))
        return losses

    tp = ModelParallelStrategy(mesh)
    model, state = create_train_state(cfg, torch.Generator().manual_seed(0),
                                      10, device="cpu")
    init = _sd_copy(model)
    state = tp.shard_state(model, state)
    step, _ = tp.make_steps(model, cfg, None)
    out = {"mesh": (mesh.n_data, mesh.n_model, mesh.data_index,
                    mesh.model_index),
           "local_query": tuple(model.spatial_0.attn.query.weight.shape),
           "metrics": run(model, state, step,
                          lambda a: a.chunk(mesh.n_data)[mesh.data_index])}
    out["params"], _ = tp.full_state(model, state.optimizer)
    if rank == 0:
        single, s_state = create_train_state(
            cfg, torch.Generator().manual_seed(0), 10, device="cpu")
        single.load_state_dict(init)
        out["single_metrics"] = run(single, s_state,
                                    make_train_step(single, cfg),
                                    lambda a: a)
        out["single_params"] = _sd_copy(single)
    return out


def suite_resume(in_dir, out_dir, rank, mesh):
    """``tests/test_multiprocess_tp_resume.py``'s resume worker: a 2-epoch
    ``Trainer`` run with ``DataParallelStrategy`` (resnet18 + pooling,
    dropout 0.1) in ``VCD_RUN``; ``VCD_DIE_AFTER_SAVE`` kills both
    processes right after that many ``last`` checkpoints, ``VCD_RESUME``
    resumes. → a hash of the final parameters."""
    import hashlib

    from vision_collision_detection_tpu_torch.parallel import (
        DataParallelStrategy,
        sync_global_devices,
    )
    from vision_collision_detection_tpu_torch.train import Trainer

    train, val, test = _synthetic_splits()
    resume = os.environ.get("VCD_RESUME") == "1"
    cfg = _bn_config(**{"model.dropout": 0.1, "data.batch_size": 1,
                        "data.num_workers": 2, "optim.optimizer": "adamw",
                        "train.epochs": 2, "train.resume": resume,
                        "train.validation_freq": 0,
                        "train.log_every_steps": 0,
                        "train.dashboard": False})
    tr = Trainer(cfg, train, val, test,
                 run_dir=os.path.join(out_dir, os.environ["VCD_RUN"]),
                 strategy=DataParallelStrategy(mesh), device="cpu")
    die_after = int(os.environ.get("VCD_DIE_AFTER_SAVE", "0"))
    if die_after:
        save, saves = tr._save, [0]

        def killing_save(role, epoch):
            save(role, epoch)
            if role == "last":
                saves[0] += 1
                if saves[0] >= die_after:
                    os._exit(9)  # a kill: no finalizers, no barriers

        tr._save = killing_save
    start_epoch = tr.start_epoch
    tr.train()
    sync_global_devices("trained")
    h = hashlib.sha256()
    for name, t in sorted(tr.model.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().contiguous().numpy().tobytes())
    return {"params_sha": h.hexdigest(), "start_epoch": start_epoch,
            "final_step": int(tr.state.step)}


SUITES = {"dp": suite_dp, "tp": suite_tp, "trainer": suite_trainer,
          "dptp": suite_dptp, "resume": suite_resume}


def main() -> int:
    suite, in_dir, out_dir = sys.argv[1:4]
    import torch

    torch.set_num_threads(2)  # beside the other test workers
    from vision_collision_detection_tpu_torch.config import MeshConfig
    from vision_collision_detection_tpu_torch.parallel import (
        create_mesh,
        maybe_initialize_distributed,
        sync_global_devices,
    )

    maybe_initialize_distributed()
    rank = torch.distributed.get_rank()
    n_model = int(os.environ.get("VCD_NUM_MODEL", "2" if suite == "tp"
                                 else "1"))
    mesh = create_mesh(MeshConfig(num_model=n_model))
    out = SUITES[suite](in_dir, out_dir, rank, mesh)
    tag = os.environ.get("VCD_TAG", suite)
    torch.save(out, os.path.join(out_dir, f"{tag}_r{rank}.pt"))
    sync_global_devices("done")
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
