"""Early-stopping strategy classes (counterpart of
``skelsplat_tpu/engine/early_stopping.py``).

These are host-side objects called once per iteration with the loss, kept
for API parity with the reference's registry. The trainer runs the same
OptEarlyStopping criterion on the device (``engine/trainer.py::
stop_offset``); these classes serve external code and the window tests.
"""

from __future__ import annotations

import numpy as np


class EarlyStopping:
    """Patience-based stopping: stop after ``patience`` calls without an
    improvement of more than ``min_delta`` (no config uses it)."""

    def __init__(self, patience=10, min_delta=1e-6):
        self.patience = patience
        self.min_delta = min_delta
        self.best_loss = float("inf")
        self.counter = 0

    def __call__(self, current_loss):
        if current_loss < self.best_loss - self.min_delta:
            self.best_loss = current_loss
            self.counter = 0
        else:
            self.counter += 1
        return self.counter >= self.patience


class OptEarlyStopping:
    """Repeating-loss-pattern detector: stop when the last two windows of
    ``window_size`` losses match elementwise within ``repeat_tolerance``."""

    def __init__(self, window_size=4, repeat_tolerance=1e-6):
        self.window_size = window_size
        self.repeat_tolerance = repeat_tolerance
        self.loss_history = []

    def __call__(self, current_loss):
        self.loss_history.append(float(current_loss))
        if len(self.loss_history) < 2 * self.window_size:
            return False
        w1 = np.array(self.loss_history[-2 * self.window_size:
                                        -self.window_size])
        w2 = np.array(self.loss_history[-self.window_size:])
        return bool(np.all(np.abs(w1 - w2) < self.repeat_tolerance))


class NotStopping:
    """Never stops: the configured default."""

    def __call__(self, current_loss):
        return False


early_stopping_strategy = {
    "opt_early_stopping": OptEarlyStopping,
    "no_stopping": NotStopping,
}
