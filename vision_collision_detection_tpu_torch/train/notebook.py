"""Notebook-recipe convenience entry.

Counterpart of ``vision_collision_detection_tpu/train/notebook.py``: the
reference's ``run_notebook_equivalent`` pins the notebook-era
hyperparameter recipe as one callable (convnext_tiny + GRU, batch 8,
lr 1e-4, weight decay 1e-4, 15 epochs, seed 42, center sampling, class
weights on, live dashboard on). From a notebook or an interactive session:

    from vision_collision_detection_tpu_torch.train import run_notebook_equivalent
    trainer, history, test_results = run_notebook_equivalent("metadata.csv")

It trains on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

from vision_collision_detection_tpu_torch.config import ExperimentConfig


def run_notebook_equivalent(
    metadata_csv: str,
    *,
    base_dirs: Sequence[str] = (),
    save_dir: str = "model_results",
    experiment_name: Optional[str] = None,
    epochs: int = 15,
    batch_size: int = 8,
    learning_rate: float = 1e-4,
    weight_decay: float = 1e-4,
    base_model: str = "convnext_tiny",
    temporal_mode: str = "gru",
    seed: int = 42,
    use_dashboard: bool = True,
    config_overrides: Optional[dict] = None,
    device=None,
):
    """→ (trainer, history, test_results): the reference's notebook recipe.

    ``config_overrides``: dotted-key overrides applied last (for example
    {"data.frame_size": 112} for a quick look on small inputs).
    ``device``: as ``Trainer``'s (the card by default)."""
    import pandas as pd

    from vision_collision_detection_tpu_torch.data import (
        create_datasets_from_directories,
        create_datasets_with_manual_split,
    )
    from vision_collision_detection_tpu_torch.train.trainer import Trainer

    cfg = ExperimentConfig().override({
        "model.backbone": base_model,
        "model.temporal_mode": temporal_mode,
        "model.num_classes": 3,
        "data.batch_size": batch_size,
        "data.sample_strategy": "center",
        "optim.learning_rate": learning_rate,
        "optim.weight_decay": weight_decay,
        "train.epochs": epochs,
        "train.seed": seed,
        "optim.use_class_weights": True,
        "train.dashboard": use_dashboard,
    })
    if config_overrides:
        cfg = cfg.override(config_overrides)

    df = pd.read_csv(metadata_csv)
    if "sensor_path" in df.columns:
        df = df.fillna({"sensor_path": ""})
    if "video_path" in df.columns or not base_dirs:
        train_ds, val_ds, test_ds = create_datasets_with_manual_split(
            df, fps=cfg.data.fps, duration=cfg.data.duration,
            frame_size=cfg.data.frame_size, seed=seed,
            eval_strategy="center", train_strategy="center",
        )
    else:
        train_ds, val_ds, test_ds = create_datasets_from_directories(
            df, list(base_dirs), fps=cfg.data.fps,
            duration=cfg.data.duration, frame_size=cfg.data.frame_size,
            seed=seed,
        )

    name = experiment_name or (
        f"{base_model}_{temporal_mode}_"
        f"{datetime.datetime.now().strftime('%Y%m%d_%H%M%S')}"
    )
    run_dir = os.path.join(save_dir, name)
    trainer = Trainer(cfg, train_ds, val_ds, test_ds, run_dir=run_dir,
                      device=device)
    history = trainer.train()
    test_results = trainer.test()
    return trainer, history, test_results
