"""The port's own train checkpoints (the JAX package keeps orbax
directories, nuhtc_tpu/utils/checkpoint.py; the port does not read them).

A checkpoint directory holds one ``step_<n>.pt`` file per saved step (the
trainer's step is the epoch), each a ``torch.save`` of a dict:
``format``, ``step`` (the train step count), ``params`` (the model's
state dict), ``ema_params`` and the AdamW state (``opt_count``, ``opt_mu``,
``opt_nu``) by parameter name, and ``cum_samples`` (the seesaw counts), all
on the CPU. A semi-supervised train state (``SemiTrainState``) is saved with
``student_params`` (the student's state dict) and ``teacher_params`` (the
teacher's parameters by name) in place of ``params`` and ``ema_params``.
``save_checkpoint(keep=)`` keeps the newest ``keep`` files;
``init_detector(path, use_ema=True)`` reads the EMA weights of a file, or of
the newest file of a directory (the teacher's of a semi one), and
``use_ema=False`` the trained ones (the student's).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch

FORMAT = "nuhtc_tpu_torch.train_state/1"
_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def checkpoint_file(path: str, step: int) -> str:
    return os.path.join(path, f"step_{int(step)}.pt")


def _steps(path: str):
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(path)) if m)


def latest_step(path: str) -> Optional[int]:
    """The newest saved step of a checkpoint directory, or None."""
    steps = _steps(path)
    return steps[-1] if steps else None


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _is_semi(state) -> bool:
    return hasattr(state, "teacher_params")


def save_checkpoint(path: str, state, model: torch.nn.Module, step: int, keep: int = 40) -> str:
    """Writes ``step_<step>.pt`` (through a temporary file, so a cut run
    leaves no half file) and removes all but the newest ``keep``."""
    os.makedirs(path, exist_ok=True)
    weights = (dict(student_params=_cpu(model.state_dict()),
                    teacher_params=_cpu(state.teacher_params)) if _is_semi(state)
               else dict(params=_cpu(model.state_dict()), ema_params=_cpu(state.ema_params)))
    blob = dict(format=FORMAT, step=int(state.step), **weights,
                opt_count=int(state.opt_state.count), opt_mu=_cpu(state.opt_state.mu),
                opt_nu=_cpu(state.opt_state.nu), cum_samples=state.cum_samples.detach().cpu())
    out = checkpoint_file(path, step)
    tmp = out + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, out)
    for old in _steps(path)[:-keep] if keep > 0 else []:
        os.remove(checkpoint_file(path, old))
    return out


def read_checkpoint(path: str, step: Optional[int] = None) -> dict:
    """The saved dict of a checkpoint file, or of ``step`` (default the
    newest) of a checkpoint directory."""
    if os.path.isdir(path):
        step = latest_step(path) if step is None else step
        if step is None:
            raise FileNotFoundError(f"{path}: no step_<n>.pt checkpoint in this directory")
        path = checkpoint_file(path, step)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of the port's trainer")
    return blob


def is_train_checkpoint(path: str) -> bool:
    """A checkpoint directory of the port's trainer, or one of its files."""
    if os.path.isdir(path):
        return latest_step(path) is not None
    return bool(_STEP_FILE.match(os.path.basename(path)))


@torch.no_grad()
def load_checkpoint(path: str, state, model: torch.nn.Module, step: Optional[int] = None):
    """Restores the model's weights (the student's of a semi state), the EMA
    (the teacher's parameters), the AdamW state, the step and the counts of
    ``state`` in place from a checkpoint; returns ``state``."""
    blob = read_checkpoint(path, step)
    semi = _is_semi(state)
    if semi != ("teacher_params" in blob):
        raise ValueError(f"{path}: a {'semi-supervised' if 'teacher_params' in blob else 'supervised'}"
                         " checkpoint for another kind of train state")
    model.load_state_dict(blob["student_params" if semi else "params"], strict=True)
    averaged = ("teacher_params", state.teacher_params) if semi else ("ema_params",
                                                                     state.ema_params)
    for name, dst in (averaged, ("opt_mu", state.opt_state.mu), ("opt_nu", state.opt_state.nu)):
        src = blob[name]
        if sorted(src) != sorted(dst):
            raise ValueError(f"{path}: {name} names differ from the model's parameters")
        for k, v in src.items():
            dst[k].copy_(v)
    state.opt_state.count = int(blob["opt_count"])
    state.step = int(blob["step"])
    state.cum_samples = blob["cum_samples"].to(state.cum_samples.device)
    return state


def checkpoint_state_dict(path: str, use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The model state dict of a checkpoint, in the key order of the JAX
    package's ``init_detector``: with ``use_ema`` the EMA weights or the
    teacher's, else the trained weights or the student's (an average is laid
    over the trained state dict, whose buffers it shares)."""
    blob = read_checkpoint(path)
    order = (("ema_params", "teacher_params", "params", "student_params") if use_ema
             else ("params", "student_params", "ema_params", "teacher_params"))
    sd = dict(blob["params"] if "params" in blob else blob["student_params"])
    for key in order:
        if blob.get(key) is not None:
            sd.update(blob[key])
            return sd
    raise ValueError(f"checkpoint {path!r} has no weights (keys: {sorted(blob)})")
