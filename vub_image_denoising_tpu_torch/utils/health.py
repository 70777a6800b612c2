"""Device health probe: does an executed op on the card come back?

Counterpart of ``vub_image_denoising_tpu/utils/health.py`` (failure
detection, SURVEY.md §5 A4).  The reference's failure handling is a
whole-run ``try/except`` plus checkpoint-resume
(diffusion_RDUnet.py:291-315, 180-193).  A device whose execution path has
died can still answer enumeration, and a call into it can block forever; a
hung C call cannot be timed out in-process, so the probe runs a small
executed matmul (``torch.matmul``: a probe, not a kernel of the port) in a
child interpreter under a hard timeout and reports (ok, seconds, detail).
"""

import subprocess
import sys
import time

_PROBE_SRC = (
    "import sys, torch\n"
    "x = torch.ones((128, 128), device=sys.argv[1])\n"
    "print('EXEC_OK', float((x @ x)[0, 0].cpu()))\n"
)


def probe_device_exec(timeout_s: float = 90.0, platform: str = ""):
    """Return (ok, seconds, detail) for the device's execution path.

    ``ok`` is True only if an executed matmul came back inside
    ``timeout_s``.  It runs on ``cuda``, or on ``cpu`` when ``platform ==
    "cpu"``.  ``detail`` is the child's last output line (or ``"timeout"`` /
    the exception text)."""
    device = "cpu" if platform == "cpu" else "cuda"
    t0 = time.time()
    try:
        out = subprocess.run(
            [sys.executable, "-c", _PROBE_SRC, device],
            capture_output=True, text=True, timeout=timeout_s,
        )
        dt = time.time() - t0
        last = (out.stdout.strip().splitlines() or [""])[-1]
        return ("EXEC_OK" in last, dt, last or out.stderr.strip()[-200:])
    except subprocess.TimeoutExpired:
        return (False, time.time() - t0, "timeout")
    except OSError as e:  # the interpreter could not be started
        return (False, time.time() - t0, f"{type(e).__name__}: {e}")


def main(argv=None):
    """CLI: exit 0 iff the execution path is healthy (for shell ``if`` guards)."""
    timeout_s = float(argv[0]) if argv else 90.0
    ok, dt, detail = probe_device_exec(timeout_s)
    print(f"device_exec ok={ok} in {dt:.1f}s: {detail}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
