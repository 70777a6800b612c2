"""Preemption-safe training: catch SIGTERM/SIGINT and stop at a safe boundary.

Counterpart of ``vub_image_denoising_tpu/utils/preempt.py``, the same code.
A scheduler that reclaims a machine sends SIGTERM first, so a trainer must
also SAVE on the way down.  ``GracefulShutdown`` converts those signals into
a flag the epoch loop polls: the in-flight epoch finishes, the trainer
writes its checkpoint, and the process exits cleanly; the next run resumes
through ``load_checkpoint``.

Usage (as the trainers' fit() loops do):

    with GracefulShutdown() as stop:
        for epoch in range(num_epochs):
            ...train one epoch...
            save_checkpoint(...)
            if stop.requested:
                break
"""

import signal


class GracefulShutdown:
    """Context manager that latches SIGTERM/SIGINT into ``requested``.

    Installs handlers on __enter__ and restores the previous ones on __exit__
    (so nested use and interactive Ctrl-C behavior outside training are
    preserved).  A SECOND signal while shutdown is pending re-raises the
    default behavior — a stuck epoch can still be killed interactively.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = signals
        self.requested = False
        self._previous = {}

    def _handler(self, signum, frame):
        if self.requested:  # second signal: give up gracefulness
            previous = self._previous.get(signum, signal.SIG_DFL)
            signal.signal(signum, previous)
            raise KeyboardInterrupt
        self.requested = True
        print(
            f"[preempt] caught signal {signum}; finishing the current epoch, "
            "checkpointing, then exiting (signal again to abort immediately)",
            flush=True,
        )

    def __enter__(self):
        for s in self.signals:
            try:
                self._previous[s] = signal.signal(s, self._handler)
            except ValueError:  # not the main thread: polling still works
                pass
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        return False
