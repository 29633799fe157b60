"""Experiment saver (mirrors ddsp_svc_tpu/train/saver.py): the expdir, the
``config.yaml`` snapshot, ``log_info.txt``, TensorBoard scalars, audio and
mel panels where ``torch.utils.tensorboard`` imports (logging only, never
the device path; panels are written as images, without matplotlib), the
model_<step> saves and their deletion, and wall-time tracking."""
from __future__ import annotations

import datetime
import os
import time

import numpy as np

from ..utils.config import save_config
from . import checkpoint as ckpt


class Saver:
    def __init__(self, args, initial_global_step: int = -1):
        self.args = args
        self.expdir = args.env.expdir
        self.sample_rate = args.data.sampling_rate
        self.global_step = initial_global_step
        self.init_time = time.time()
        self.last_time = time.time()
        os.makedirs(self.expdir, exist_ok=True)
        self.path_log_info = os.path.join(self.expdir, "log_info.txt")
        save_config(os.path.join(self.expdir, "config.yaml"), args)
        self.writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(os.path.join(self.expdir, "logs"))
        except Exception:
            pass

    def log_info(self, msg) -> None:
        if isinstance(msg, dict):
            lines = []
            for k, v in msg.items():
                if isinstance(v, dict):
                    lines.append(f"{k}:")
                    lines += [f" {kk}: {vv}" for kk, vv in v.items()]
                else:
                    lines.append(f"{k}: {v}")
            msg = "\n".join(lines)
        print(msg, flush=True)
        with open(self.path_log_info, "a") as f:
            f.write(msg + "\n")

    def log_value(self, dct: dict) -> None:
        if self.writer is not None:
            for k, v in dct.items():
                self.writer.add_scalar(k, float(v), self.global_step)

    def log_audio(self, dct: dict) -> None:
        if self.writer is not None:
            for k, v in dct.items():
                self.writer.add_audio(k, np.asarray(v).reshape(-1, 1),
                                      self.global_step,
                                      sample_rate=self.sample_rate)

    def log_spec(self, name: str, spec, spec_out) -> None:
        """diff | gt | pred mel panel, scaled from [-9, 2] to [0, 1]."""
        if self.writer is None:
            return
        gt = np.asarray(spec).squeeze().T
        pred = np.asarray(spec_out).squeeze().T
        panel = np.concatenate([pred - gt, gt, pred], axis=0)[::-1]
        self.writer.add_image(name, np.clip((panel + 9.0) / 11.0, 0.0, 1.0),
                              self.global_step, dataformats="HW")

    def get_interval_time(self) -> float:
        now = time.time()
        dt, self.last_time = now - self.last_time, now
        return dt

    def get_total_time(self, to_str: bool = True):
        total = time.time() - self.init_time
        return str(datetime.timedelta(seconds=total))[:-5] if to_str else total

    def save_model(self, model, opt_state=None, postfix=None) -> str:
        step = self.global_step if postfix is None else postfix
        path = ckpt.save_checkpoint(self.expdir, int(step), model,
                                    self.args.model, opt_state)
        self.log_info(f" [*] model saved: {path}")
        return path

    def delete_model(self, postfix: int) -> None:
        ckpt.delete_checkpoint(self.expdir, postfix)

    def global_step_increment(self) -> None:
        self.global_step += 1
