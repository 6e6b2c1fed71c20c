"""Training engine: epoch loop, mini-validation cascade, early stopping,
best-checkpoint tracking, history artifacts, true resume.

Counterpart of ``vision_collision_detection_tpu/train/trainer.py``, with the
same public names, artifacts and cascade:

- mini-validation cascade: every ``steps_per_epoch // validation_freq``
  steps, ``mini_val_batches`` shuffled validation batches; if the mini loss
  improves, a full validation; if the full loss improves, ``best`` is saved.
- early stopping after ``patience`` epochs without a better validation
  loss; ``best`` is chosen on the validation loss and reloaded at the end.
- artifacts: the ``best``, ``last`` and ``epoch_N`` checkpoints,
  ``training_history.csv``, ``validation_epoch{N}.json``,
  ``test_results.json`` and ``test_predictions.csv``, written without
  pandas.
- a resume restores the model, the AdamW moments, the step count, the
  epoch, the best losses and the history, and draws what an uninterrupted
  run would have drawn: each step's generator is seeded from
  ``(train.seed, epoch * 131071 + step, rank)``.

The loop only queues work on the device: batches reach it through
``device_feed`` (keys ``frames``, ``sensor``, ``target`` and ``mask``, the
last ``~(error | pad)`` as float32), the running metrics are summed there
and read at a ``log_every_steps`` window and at the end of the epoch, and
an evaluation stashes its outputs and reads them once after its last
batch.

The parallel strategy is injected: ``SingleDeviceStrategy`` (in
``train/steps.py``, beside the step bodies that call its collectives),
``DataParallelStrategy`` and ``ModelParallelStrategy`` in ``parallel/``
(one process per device, launched by ``torchrun``). Its contract is the
JAX trainer's: the loaders shard by ``num_data_shards`` and
``data_shard_index`` (model peers of tensor parallelism read the same
batch), each device takes ``batch_size`` clips, ``make_steps`` gives the
steps, ``gather_eval`` joins the shards' evaluation outputs, and
``is_main`` writes the artifacts; ``shard_state`` cuts the model after it
is built (tensor parallelism), and ``full_state`` / ``load_full_state`` move
the checkpoints' full tensors.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from vision_collision_detection_tpu_torch.ckpt import CheckpointStore
from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.data.loader import (
    ClipLoader,
    device_feed,
)
from vision_collision_detection_tpu_torch.metrics import classification_metrics
from vision_collision_detection_tpu_torch.obs.history import (
    TrainingHistory,
    save_metrics_json,
    save_predictions_csv,
)
from vision_collision_detection_tpu_torch.obs.logging_utils import (
    setup_logging,
)
from vision_collision_detection_tpu_torch.train.steps import (
    SingleDeviceStrategy,
    create_train_state,
)
from vision_collision_detection_tpu_torch.utils.device import resolve_device
from vision_collision_detection_tpu_torch.utils.rng import derive_seed

FEED_KEYS = ("frames", "sensor", "target", "mask")


def step_seed(seed: int, epoch: int, step: int, rank: int = 0) -> int:
    """The seed of the generator of training step ``step`` of ``epoch`` on
    data shard ``rank``: the counterpart of the JAX trainer's two
    ``fold_in``s of ``PRNGKey(seed)`` and its DP step's fold of the shard
    index."""
    return derive_seed(seed, epoch * 131071 + step, rank)


def _with_mask(loader) -> Iterator[dict]:
    """The loader's batches, each with ``mask``: ``~(error | pad)`` as
    float32, the samples the loss and the metrics count."""
    for batch in loader:
        yield dict(batch, mask=(~(batch["error"] | batch["pad"])).astype(
            np.float32))


def _ids_to_bytes(ids, width: int = 256) -> np.ndarray:
    """Fixed-shape uint8 encoding so string ids can be gathered across
    processes beside the prediction arrays (keeps test_predictions.csv rows
    aligned under multi-process eval)."""
    arr = np.zeros((len(ids), width), np.uint8)
    for i, s in enumerate(ids):
        b = str(s).encode("utf-8")[:width]
        arr[i, : len(b)] = np.frombuffer(b, np.uint8)
    return arr


def _bytes_to_ids(arr: np.ndarray) -> list:
    return [bytes(row[row != 0]).decode("utf-8", "replace") for row in arr]


class Trainer:
    def __init__(
        self,
        cfg: ExperimentConfig,
        train_ds,
        val_ds,
        test_ds=None,
        run_dir: Optional[str] = None,
        strategy=None,
        device=None,
    ):
        """``device``: where the model trains, the card by default (under
        ``torchrun`` the rank's card, made current by
        ``maybe_initialize_distributed``); a CUDA device without a card
        raises (tests pass ``"cpu"``)."""
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.strategy = strategy or SingleDeviceStrategy()
        self.run_dir = run_dir or os.path.join(cfg.save_dir, cfg.name())
        os.makedirs(self.run_dir, exist_ok=True)
        self.log = setup_logging(self.run_dir)
        self.store = CheckpointStore(self.run_dir, cfg.train.keep_checkpoints)

        dc = cfg.data
        pad_partial = getattr(self.strategy, "pad_batches", False)
        if dc.content_box_transfer:
            self._enable_content_box(train_ds, val_ds, test_ds)
        if dc.fast_resize:
            for ds in (train_ds, val_ds, test_ds):
                if ds is not None:
                    ds.fast_resize = True
        if dc.lowres_decode:
            for ds in (train_ds, val_ds, test_ds):
                if ds is not None:
                    ds.lowres_decode = int(dc.lowres_decode)
        shards = {"num_shards": self.strategy.num_data_shards,
                  "shard_index": self.strategy.data_shard_index,
                  "pad_partial": pad_partial}
        # one process per device: the per-device batch is the process's
        batch_size = dc.batch_size
        self.train_loader = ClipLoader(
            train_ds, batch_size, shuffle=True,
            drop_last=dc.drop_last_train, num_workers=dc.num_workers,
            prefetch_batches=dc.prefetch_depth, seed=dc.seed, **shards,
        )
        self.val_loader = ClipLoader(
            val_ds, batch_size, shuffle=False, drop_last=False,
            num_workers=dc.num_workers, seed=dc.seed, mask_wrap=True,
            **shards,
        )
        self.mini_val_loader = ClipLoader(
            val_ds, batch_size, shuffle=True, drop_last=False,
            num_workers=dc.num_workers, seed=dc.seed + 1, mask_wrap=True,
            **shards,
        )
        self.test_loader = (
            ClipLoader(
                test_ds, batch_size, shuffle=False, drop_last=False,
                num_workers=dc.num_workers, seed=dc.seed, mask_wrap=True,
                **shards,
            )
            if test_ds is not None else None
        )

        self.class_weights = (
            train_ds.class_weights() if cfg.optim.use_class_weights else None
        )
        self.steps_per_epoch = max(1, len(self.train_loader))
        self.model, self.state = create_train_state(
            cfg, torch.Generator().manual_seed(cfg.train.seed),
            self.steps_per_epoch, device=self.device,
        )
        self.state = self.strategy.shard_state(self.model, self.state)
        self.train_step, self.eval_step = self.strategy.make_steps(
            self.model, cfg, self.class_weights
        )

        self.history = TrainingHistory(dc.class_names)
        self.best_val_loss = float("inf")
        self.best_mini_loss = float("inf")
        self.start_epoch = 0
        self._viz = None  # the dashboard of a run, rendered by the cascade
        self._profiler = None

        if cfg.train.resume and self.store.exists("last"):
            self._resume()

    def _enable_content_box(self, *datasets) -> None:
        """Ship letterbox content rows and pad the bars on the device (K1;
        bit-equal to the square decode, see ``DataConfig``).

        Guarded against mixed aspects: every record of every dataset is
        probed (a probe reads the container's header), and the box is set
        only when all agree; a clip of another aspect would otherwise be
        letterboxed twice. The JAX trainer probes 8 records a dataset, so a
        set whose odd clip falls between its samples keeps the box there.
        A record whose probe fails (``MediaError``, ``OSError``,
        ``ValueError``) will not decode either: it is logged and has no
        say, where the JAX trainer turns the box off when such a record is
        among its samples. The box stays off when no record can be probed
        or the content is already square; a media library that cannot be
        built raises.
        """
        from vision_collision_detection_tpu_torch.media.decoder import (
            MediaError,
            probe,
        )
        from vision_collision_detection_tpu_torch.ops.letterbox import (
            letterbox_geometry,
        )

        S = self.cfg.data.frame_size
        geoms, failed, n = set(), [], 0
        for ds in datasets:
            for rec in getattr(ds, "records", None) or ():
                n += 1
                try:
                    info = probe(rec.video_path)
                except (MediaError, OSError, ValueError) as e:
                    failed.append(f"{type(e).__name__}: {e}")
                    continue
                geoms.add(letterbox_geometry(info.height, info.width, S)[:2])
        if failed:
            self.log.warning(
                "content-box probe failed for %d of %d clips (first: %s); "
                "they decode as failed clips", len(failed), n, failed[0],
            )
        if len(geoms) > 1:
            self.log.warning(
                "content-box transfer disabled: datasets mix aspect ratios "
                "%s — falling back to square decode", sorted(geoms),
            )
            return
        if not geoms:
            if failed:
                self.log.warning(
                    "content-box transfer disabled: no clip could be probed "
                    "— falling back to square decode")
            return
        nh, nw = next(iter(geoms))
        box = (min(nh + nh % 2, S), min(nw + nw % 2, S))
        if box == (S, S):
            return
        for ds in datasets:
            if ds is not None and getattr(ds, "content_box", None) is None:
                ds.content_box = box

    # ------------------------------------------------------------------
    # checkpoint plumbing
    # ------------------------------------------------------------------
    def _arrays(self) -> dict:
        """What a checkpoint holds: the full tensors on every process (a
        collective under tensor parallelism)."""
        model_sd, optimizer_sd = self.strategy.full_state(
            self.model, self.state.optimizer)
        return {"model": model_sd, "optimizer": optimizer_sd,
                "step": int(self.state.step)}

    def _meta(self, epoch: int) -> dict:
        return {
            "epoch": epoch,
            "best_val_loss": self.best_val_loss,
            "best_mini_loss": self.best_mini_loss,
            "history": self.history.to_list(),
            "hyperparams": self.cfg.to_dict(),
            "class_weights": (
                self.class_weights.tolist()
                if self.class_weights is not None else None
            ),
        }

    def _save(self, role: str, epoch: int) -> None:
        self.store.save(role, arrays=self._arrays(), meta=self._meta(epoch))

    def _restore_arrays(self, arrays: dict) -> None:
        self.strategy.load_full_state(self.model, self.state.optimizer,
                                      arrays["model"], arrays["optimizer"])
        self.state.step = int(arrays["step"])

    def _resume(self) -> None:
        arrays, meta = self.store.load("last", map_location=self.device)
        self._restore_arrays(arrays)
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.best_val_loss = float(meta.get("best_val_loss", float("inf")))
        self.best_mini_loss = float(meta.get("best_mini_loss", float("inf")))
        if meta.get("history"):
            self.history = TrainingHistory.from_list(
                self.cfg.data.class_names, meta["history"]
            )
        self.log.info(
            "resumed from epoch %d (step %d)", self.start_epoch, self.state.step
        )

    def load_role(self, role: str) -> None:
        arrays, _ = self.store.load(role, map_location=self.device)
        self._restore_arrays(arrays)

    def _feed(self, loader: ClipLoader):
        """The loader's batches on the trainer's device; closing it stops
        the feed's producer."""
        return contextlib.closing(
            device_feed(_with_mask(loader), self.device, keys=FEED_KEYS))

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def evaluate(self, loader: ClipLoader, max_batches: Optional[int] = None,
                 epoch: int = 0) -> Dict:
        """Evaluation of this process's shard, gathered by the strategy."""
        loader.set_epoch(epoch)
        t_eval = time.time()
        use_sensor = self.cfg.model.use_sensor
        # The loop only queues work: the device outputs are stashed and
        # read once after the last batch.
        dev_outs, masks, pads, ids = [], [], [], []
        with self._feed(loader) as it:
            for i, batch in enumerate(it):
                if max_batches is not None and i >= max_batches:
                    break
                mask_np = ~(batch["error"] | batch["pad"])  # on the host
                kw = {"sensor": batch["sensor"]} if use_sensor else {}
                out = self.eval_step(batch["frames"], batch["target"],
                                     batch["mask"], **kw)
                dev_outs.append((out["probs"], out["preds"], out["loss"],
                                 batch["target"]))
                masks.append(mask_np)
                pads.append(np.asarray(batch["pad"], bool))
                ids.extend(batch["id"])  # pads filtered after the gather
        if not dev_outs:
            return {"loss": float("nan"), "num_samples": 0}

        to_host = self.strategy.to_host
        probs, preds, losses, targets = zip(*dev_outs)
        counts = [int(m.sum()) for m in masks]
        losses = to_host(torch.stack(losses)).tolist()
        arrays = {
            "probs": to_host(torch.cat(probs)).astype(np.float32),
            "preds": to_host(torch.cat(preds)),
            "targets": to_host(torch.cat(targets)),
            "mask": np.concatenate(masks),
            "pad": np.concatenate(pads),
            "ids": _ids_to_bytes(ids),
            "loss_sum": np.array(
                [sum(l * c for l, c in zip(losses, counts))],
                np.float64),
            "count": np.array([sum(counts)], np.float64),
        }
        arrays = self.strategy.gather_eval(arrays)
        keep = ~arrays["pad"]
        for k in ("probs", "preds", "targets", "mask"):
            arrays[k] = arrays[k][keep]
        ids = _bytes_to_ids(arrays["ids"][keep])

        m = arrays["mask"]
        metrics = classification_metrics(
            arrays["targets"][m], arrays["preds"][m], arrays["probs"][m],
            self.cfg.model.num_classes, self.cfg.data.class_names,
        )
        total = max(float(arrays["count"].sum()), 1.0)
        metrics["loss"] = float(arrays["loss_sum"].sum() / total)
        metrics["eval_time_sec"] = time.time() - t_eval
        metrics["ids"] = ids
        metrics["_probs"] = arrays["probs"]
        metrics["_preds"] = arrays["preds"]
        metrics["_targets"] = arrays["targets"]
        return metrics

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def train(self, epochs: Optional[int] = None) -> TrainingHistory:
        tc = self.cfg.train
        epochs = epochs or tc.epochs
        patience_left = tc.patience
        viz = None
        if tc.dashboard:
            from vision_collision_detection_tpu_torch.obs.dashboard import (
                create_distributed_visualizer,
            )

            viz = create_distributed_visualizer(
                epochs, self.steps_per_epoch, self.run_dir
            )
        self._viz = viz
        self.log.info(
            "training %s: %d epochs × %d steps, %d val clips",
            self.cfg.name(), epochs, self.steps_per_epoch,
            len(self.val_loader.dataset),
        )
        if len(self.val_loader.dataset) == 0:
            self.log.warning(
                "validation set is EMPTY: no best-checkpoint tracking or "
                "early stopping will happen"
            )

        if tc.profile_steps > 0 and self.strategy.is_main:
            self._profiler = self._start_profiler()
        for epoch in range(self.start_epoch, epochs):
            t0 = time.time()
            if viz:
                viz.start_epoch(epoch)
            train_metrics = self._train_epoch(epoch)
            val = self.evaluate(self.val_loader, epoch=epoch)
            if viz:
                viz.update_full_val_metrics(
                    {k: v for k, v in val.items()
                     if isinstance(v, (int, float))}
                )
                viz.mark_epoch(epoch, train_metrics=dict(train_metrics))
            epoch_time = time.time() - t0
            lr = float(self.state.schedule(self.state.step))
            self.history.append_epoch(
                epoch, train_metrics, val, lr=lr, epoch_time_sec=epoch_time
            )
            self.log.info(
                "epoch %d done in %.1fs: train loss %.4f val loss %.4f "
                "val acc %.3f val auc %s",
                epoch, epoch_time, train_metrics["loss"], val["loss"],
                val.get("accuracy", float("nan")),
                f"{val['auc']:.4f}" if "auc" in val and np.isfinite(
                    val.get("auc", np.nan)) else "n/a",
            )

            if self.strategy.is_main:
                save_metrics_json(
                    os.path.join(self.run_dir, f"validation_epoch{epoch}.json"),
                    {k: v for k, v in val.items() if not k.startswith("_")
                     and k != "ids"},
                )
                self.history.save_csv(
                    os.path.join(self.run_dir, "training_history.csv")
                )
            if val["loss"] < self.best_val_loss:
                self.best_val_loss = val["loss"]
                self._save("best", epoch)
                patience_left = tc.patience
            else:
                patience_left -= 1
            if tc.checkpoint_every_epochs and (
                epoch % tc.checkpoint_every_epochs == 0
            ):
                self.store.save_epoch(
                    epoch, arrays=self._arrays(), meta=self._meta(epoch)
                )
            self._save("last", epoch)

            if patience_left <= 0:
                self.log.info("early stopping at epoch %d", epoch)
                break

        if self._profiler is not None:
            self._stop_profiler()
        if self.strategy.is_main and self.history.records:
            try:
                from vision_collision_detection_tpu_torch.obs.plots import (
                    plot_training_curves,
                )

                plot_training_curves(
                    self.history.to_dataframe(),
                    os.path.join(self.run_dir, "training_curves.png"),
                )
            except Exception as e:  # plotting must never kill a run
                self.log.warning("training-curve plot failed: %s", e)
        # reload best for the test and inference that follow
        if self.store.exists("best"):
            self.load_role("best")
        return self.history

    def _train_epoch(self, epoch: int) -> Dict[str, float]:
        """The training steps of one epoch, with the mini-validation
        cascade every ``steps_per_epoch // validation_freq`` steps; → the
        epoch's mean loss and accuracy, read from the device once."""
        tc = self.cfg.train
        t0 = time.time()
        mini_every = (max(1, self.steps_per_epoch // tc.validation_freq)
                      if tc.validation_freq > 0 else 0)
        use_sensor = self.cfg.model.use_sensor
        shard = self.strategy.data_shard_index
        viz = self._viz
        generator = torch.Generator(device=self.device)
        self.train_loader.set_epoch(epoch)
        acc = None  # device-side running metric sums, read lazily
        n_steps = 0
        with self._feed(self.train_loader) as it:
            for step_i, batch in enumerate(it):
                generator.manual_seed(step_seed(tc.seed, epoch, step_i, shard))
                kw = {"sensor": batch["sensor"]} if use_sensor else {}
                self.state, m = self.train_step(
                    self.state, batch["frames"], batch["target"],
                    batch["mask"], generator, **kw,
                )
                # no host read here: one device add per metric keeps the
                # host ahead of the device
                acc = m if acc is None else {k: acc[k] + v
                                             for k, v in m.items()}
                n_steps += 1
                if self._profiler is not None and \
                        n_steps >= tc.profile_steps:
                    self._stop_profiler()
                if tc.log_every_steps and n_steps % tc.log_every_steps == 0:
                    vals = _read(acc)  # one read per log window
                    self.log.info(
                        "epoch %d step %d/%d loss %.4f acc %.3f (%.2f it/s)",
                        epoch, n_steps, self.steps_per_epoch,
                        vals["loss"] / n_steps, vals["accuracy"] / n_steps,
                        n_steps / max(time.time() - t0, 1e-6),
                    )
                    if viz:
                        viz.update_train_loss(vals["loss"] / n_steps,
                                              n_steps)
                if mini_every and (step_i + 1) % mini_every == 0:
                    self._mini_validate_cascade(epoch)
        vals = (_read(acc) if acc is not None
                else {"loss": 0.0, "accuracy": 0.0})
        return {"loss": vals["loss"] / max(n_steps, 1),
                "accuracy": vals["accuracy"] / max(n_steps, 1)}

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self) -> None:
        """Stop the trace and write it as ``<run_dir>/profile/trace.json``
        (Chrome trace format)."""
        profiler, self._profiler = self._profiler, None
        profiler.stop()
        path = os.path.join(self.run_dir, "profile", "trace.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        profiler.export_chrome_trace(path)
        self.log.info("profiler trace written to %s", path)

    def _mini_validate_cascade(self, epoch: int) -> None:
        tc = self.cfg.train
        mini = self.evaluate(
            self.mini_val_loader, max_batches=tc.mini_val_batches, epoch=epoch
        )
        viz = self._viz
        if viz:
            viz.update_val_metrics(
                {k: v for k, v in mini.items() if isinstance(v, (int, float))}
            )
        if mini.get("num_samples", 0) and mini["loss"] < self.best_mini_loss:
            self.best_mini_loss = mini["loss"]
            full = self.evaluate(self.val_loader, epoch=epoch)
            self.log.info(
                "mini-val improved (%.4f) → full val loss %.4f",
                mini["loss"], full["loss"],
            )
            if viz:
                viz.update_full_val_metrics(
                    {k: v for k, v in full.items()
                     if isinstance(v, (int, float))}
                )
            if full["loss"] < self.best_val_loss:
                self.best_val_loss = full["loss"]
                self._save("best", epoch)

    # ------------------------------------------------------------------
    # test
    # ------------------------------------------------------------------
    def test(self) -> Dict:
        if self.test_loader is None:
            raise ValueError("no test dataset configured")
        role = self.store.latest_role()
        if role:
            self.load_role(role)
            self.log.info("testing with checkpoint role %r", role)
        metrics = self.evaluate(self.test_loader)
        if self.strategy.is_main and metrics.get("confusion_matrix"):
            try:
                from vision_collision_detection_tpu_torch.obs.plots import (
                    plot_confusion_matrix,
                )

                plot_confusion_matrix(
                    metrics["confusion_matrix"], self.cfg.data.class_names,
                    os.path.join(self.run_dir, "confusion_matrix.png"),
                )
            except Exception as e:  # plotting must never kill a run
                self.log.warning("confusion-matrix plot failed: %s", e)
        if self.strategy.is_main:
            save_metrics_json(
                os.path.join(self.run_dir, "test_results.json"),
                {k: v for k, v in metrics.items() if not k.startswith("_")
                 and k != "ids"},
            )
            if metrics.get("num_samples", 0):
                n = min(len(metrics["ids"]), len(metrics["_targets"]))
                save_predictions_csv(
                    os.path.join(self.run_dir, "test_predictions.csv"),
                    metrics["ids"][:n], metrics["_targets"][:n],
                    metrics["_preds"][:n], metrics["_probs"][:n],
                    self.cfg.data.class_names,
                )
        return metrics


def _read(acc: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The running sums on the host: one read of the device."""
    keys = list(acc)
    return dict(zip(keys, torch.stack([acc[k].float() for k in keys])
                    .tolist()))
