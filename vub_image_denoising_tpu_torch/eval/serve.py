"""HTTP inference server — the serving surface of the port.

Counterpart of ``vub_image_denoising_tpu/eval/serve.py``: a checkpoint is
loaded once, then every request (or coalesced batch of requests) is one
forward on the card, or with ``--arch diffusion`` one run of the T-step
sampler (``--timesteps``).  Stdlib-only (``http.server``).

Endpoints:
  GET  /healthz    -> JSON: device, arch, request shapes seen, latency
                      percentiles, batching counters, and a per-phase
                      breakdown (decode / queue / device / encode).
  POST /denoise    -> image bytes (PNG/JPEG) in, denoised PNG out.  Raw mode
                      for throughput clients: Content-Type:
                      application/octet-stream + X-Shape: H,W,C with raw
                      uint8 HWC bytes, and/or Accept: application/octet-stream
                      to get raw uint8 back (X-Shape echoed).

Error mapping: undecodable input -> 400; queue at capacity or service
shutting down -> 503 (with Retry-After); an internal fault -> 500.

Requests serialize through one dispatcher: one card runs one batch at a time,
which keeps device memory bounded at one batch.  Dynamic batching (default
--max-batch 8) coalesces concurrent same-shape requests into one forward.

Usage:
  python -m vub_image_denoising_tpu_torch.eval.serve --checkpoint ck.pth \
      --base-filters 32 --bf16 --port 8900
  python -m vub_image_denoising_tpu_torch.eval.serve --checkpoint diffusion.pth \
      --arch diffusion --timesteps 20 [--engine auto|flax|xla|pallas]
  curl -s -X POST --data-binary @noisy.png localhost:8900/denoise > clean.png
  torchrun --nproc-per-node 2 -m vub_image_denoising_tpu_torch.eval.serve \
      --checkpoint ck.pth --tensor-parallel   # rank 0 serves, both compute
"""

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .denoise_cli import ENGINES, build_denoiser, resolve_device


class QueueFullError(Exception):
    """Queue at capacity or service closing (mapped to HTTP 503)."""


class BadRequestError(Exception):
    """Client sent something we cannot decode (mapped to HTTP 400)."""


class _LatencyWindow:
    """Rolling per-request wall-time window -> p50/p90/p99 for /healthz.

    Also keeps lifetime totals (sum/count over ALL samples, not just the
    window) so /healthz can attribute aggregate wall-clock to phases."""

    def __init__(self, maxlen: int = 1000):
        from collections import deque

        self._lock = threading.Lock()
        self._samples = deque(maxlen=maxlen)
        self._total = 0.0
        self._count = 0

    def record(self, seconds: float):
        with self._lock:
            self._samples.append(seconds)
            self._total += seconds
            self._count += 1

    def reset(self):
        with self._lock:
            self._samples.clear()
            self._total = 0.0
            self._count = 0

    def percentiles(self):
        with self._lock:
            if not self._samples:
                return {"n": 0}
            ms = np.sort(np.asarray(self._samples)) * 1000.0
            total, count = self._total, self._count
        return {
            "n": count,
            "p50_ms": round(float(np.percentile(ms, 50)), 2),
            "p90_ms": round(float(np.percentile(ms, 90)), 2),
            "p99_ms": round(float(np.percentile(ms, 99)), 2),
            "mean_ms": round(total / count * 1000.0, 2),
            "total_s": round(total, 3),
        }


class DenoiseService:
    """Holds the warm denoiser; thread-safe single-flight execution.

    Subclasses override ``_denoise_array`` (array in -> array out); the
    decode/normalize/encode pipeline in ``denoise_request`` is shared so the
    two paths cannot drift.
    """

    def __init__(self, denoise_fn, grayscale: bool = False,
                 png_compress_level: int = 1):
        self.denoise_fn = denoise_fn
        self.grayscale = grayscale
        # PNG encode is pure host-CPU serving cost; level 1 encodes several
        # times faster than Pillow's default 6 for more bytes on smooth
        # (denoised) content.  Archival clients can ask for 6+.
        self.png_compress_level = int(png_compress_level)
        self._lock = threading.Lock()  # serializes device dispatch
        self._meta = threading.Lock()  # guards shapes_seen / stats vs /healthz
        self.shapes_seen = set()
        self.latency = _LatencyWindow()
        # per-request phase attribution ("where does a request's wall go?"):
        # decode (bytes -> normalized array, host), queue (wait for the device
        # lock / batch dispatch), device (forward incl. transfers; recorded
        # per DISPATCH, so batched requests share one sample), encode
        # (array -> PNG bytes, host).  total_s across phases ~ latency total.
        self.phases = {k: _LatencyWindow() for k in
                       ("decode", "queue", "device", "encode")}

    def _denoise_array(self, x: np.ndarray) -> np.ndarray:
        with self._meta:
            self.shapes_seen.add(tuple(x.shape))
        t0 = time.monotonic()
        with self._lock:
            t1 = time.monotonic()
            y = np.asarray(self.denoise_fn(x))
        self.phases["queue"].record(t1 - t0)
        self.phases["device"].record(time.monotonic() - t1)
        return y

    def denoise_request(self, payload: bytes, raw_shape=None,
                        raw_out: bool = False):
        """PNG in/out by default; ``raw_shape=(H, W, C)`` treats ``payload`` as
        raw uint8 HWC bytes and ``raw_out`` returns raw uint8 bytes — the
        codec-free path for throughput clients.  Returns ``(body, out_shape)``
        so the HTTP handler can echo ``X-Shape`` on raw responses."""
        t0 = time.monotonic()
        if raw_shape is not None:
            h, w, c = raw_shape
            if h <= 0 or w <= 0 or c <= 0:
                # a 400, not a 500: negative dims can pass the byte-length
                # check ((-h)*(-w)*c) and crash reshape as a "server fault",
                # which a balancer would retry forever
                raise BadRequestError(f"X-Shape dims must be positive: {h},{w},{c}")
            want = 1 if self.grayscale else 3
            if c != want:
                raise BadRequestError(
                    f"X-Shape channels {c} != served model channels {want}")
            if len(payload) != h * w * c:
                raise BadRequestError(
                    f"raw body is {len(payload)} bytes, X-Shape {h},{w},{c} "
                    f"needs {h * w * c}")
            arr = np.frombuffer(payload, np.uint8).reshape(h, w, c)
        else:
            from PIL import Image

            try:
                img = Image.open(io.BytesIO(payload))
                img = img.convert("L") if self.grayscale else img.convert("RGB")
            except Exception as e:
                raise BadRequestError(f"cannot decode image: {e}") from e
            arr = np.asarray(img, np.uint8)
            if arr.ndim == 2:
                arr = arr[..., None]
        x = arr.astype(np.float32) / 255.0 * 2.0 - 1.0  # Normalize(0.5, 0.5)
        t1 = time.monotonic()
        self.phases["decode"].record(t1 - t0)
        y = self._denoise_array(x)
        t2 = time.monotonic()
        out = np.clip((y + 1.0) * 0.5 * 255.0 + 0.5, 0, 255).astype(np.uint8)
        if raw_out:
            body = out.tobytes()
        else:
            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(out[..., 0] if out.shape[-1] == 1 else out).save(
                buf, format="PNG", compress_level=self.png_compress_level
            )
            body = buf.getvalue()
        self.phases["encode"].record(time.monotonic() - t2)
        self.latency.record(time.monotonic() - t0)
        return body, tuple(out.shape)

    def snapshot(self) -> dict:
        """Consistent /healthz payload (takes the metadata lock — the request
        path mutates ``shapes_seen`` concurrently)."""
        with self._meta:
            payload = {"shapes_compiled": sorted(map(list, self.shapes_seen))}
        payload["latency"] = self.latency.percentiles()
        payload["phases"] = {k: w.percentiles() for k, w in self.phases.items()}
        return payload

    def reset_stats(self):
        """Zero the latency/phase windows (and batching counters).

        Benchmarks call this between the warmup and the timed window so
        first-use cost (the kernel build, cuDNN autotuning) cannot pollute
        the phase attribution."""
        self.latency.reset()
        for w in self.phases.values():
            w.reset()
        with self._meta:
            if hasattr(self, "stats"):
                self.stats = {k: 0 for k in self.stats}

    def prewarm(self, shape, dtype=np.float32):
        """Run every batch shape a request of HWC ``shape`` can hit once.

        The plain service has one shape per input shape; the batching
        subclass walks all power-of-two batch buckets.  Deterministic —
        unlike load-generated warmup, which only touches whatever bucket
        sizes the burst happens to form."""
        self.denoise_fn(np.zeros(shape, dtype))

    def close(self):  # symmetric with BatchingDenoiseService
        pass


class _Pending:
    """One in-flight request in the batching queue."""

    __slots__ = ("x", "out", "err", "done", "t_enq")

    def __init__(self, x):
        self.x = x
        self.out = None
        self.err = None
        self.done = threading.Event()
        self.t_enq = time.monotonic()


class BatchingDenoiseService(DenoiseService):
    """Dynamic request batching: concurrent same-shape requests coalesce into
    ONE device dispatch.

    Per-request dispatch leaves the card mostly idle under concurrent load, so
    batching is the first serving-throughput lever.  Requests enqueue
    per input shape; a single dispatcher thread lingers ``max_wait_ms`` for a
    burst to land (skipped when a full ``max_batch`` is already waiting), pops
    up to ``max_batch`` same-shape requests, rounds the batch dim up to a
    power of two (bounds the per-shape batch shapes at log2(max_batch)+1;
    pad rows are edge-repeats, sliced off), and
    runs them as one forward.  Mixed-shape traffic still works — each shape is
    its own queue and the largest queue dispatches first.

    ``denoise_fn`` here is the BATCHED denoiser: (N,H,W,C) -> (N,H,W,C)
    (``build_denoiser(..., batched=True)``).
    """

    def __init__(self, batch_denoise_fn, grayscale: bool = False,
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 max_queue: int = 256, png_compress_level: int = 1):
        super().__init__(batch_denoise_fn, grayscale=grayscale,
                         png_compress_level=png_compress_level)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        self._cv = threading.Condition()
        self._queues = {}  # shape tuple -> list[_Pending]
        self._closed = False
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0,
                      "rejected": 0}
        self._dispatcher = threading.Thread(target=self._loop, daemon=True)
        self._dispatcher.start()

    # -- request side -----------------------------------------------------
    def _denoise_array(self, x: np.ndarray) -> np.ndarray:
        p = _Pending(x)
        with self._cv:
            if self._closed:
                raise QueueFullError("service is shutting down")
            queued = sum(len(q) for q in self._queues.values())
            rejected = queued >= self.max_queue
            if not rejected:
                self._queues.setdefault(x.shape, []).append(p)
                self._cv.notify()
        with self._meta:
            if rejected:
                self.stats["rejected"] += 1
            else:
                self.stats["requests"] += 1
                self.shapes_seen.add(tuple(x.shape))
        if rejected:
            # backpressure: reject instead of growing an unbounded queue
            # (the client retries against a less-loaded replica)
            raise QueueFullError(
                f"{queued} requests queued (max_queue={self.max_queue})"
            )
        p.done.wait()
        if p.err is not None:
            raise p.err
        return p.out

    def snapshot(self) -> dict:
        payload = super().snapshot()
        with self._meta:
            payload["batching"] = dict(self.stats)
        return payload

    def prewarm(self, shape, dtype=np.float32):
        """Run every power-of-two batch bucket for HWC ``shape`` once:
        _run_batch rounds N up to a power of two, so buckets 1,2,4,...,
        max_batch are every batch shape this input shape can hit."""
        nb = 1
        while True:
            self.denoise_fn(np.zeros((nb,) + tuple(shape), dtype))
            if nb >= self.max_batch:
                break
            nb *= 2

    # -- dispatcher side ---------------------------------------------------
    def _collect(self):
        """Block until work exists, linger for a burst, pop one shape's batch."""
        with self._cv:
            while not self._closed and not any(self._queues.values()):
                self._cv.wait()
            if self._closed:
                return None
            # a full batch is already waiting: dispatch now, don't idle the
            # device for the linger window under saturation
            full = any(len(q) >= self.max_batch for q in self._queues.values())
        if self.max_wait_ms > 0 and not full:
            time.sleep(self.max_wait_ms / 1000.0)  # let the burst land
        with self._cv:
            live = {s: q for s, q in self._queues.items() if q}
            if not live:
                return None
            shape = max(live, key=lambda s: len(live[s]))
            q = self._queues[shape]
            batch, self._queues[shape] = q[: self.max_batch], q[self.max_batch:]
            return batch

    def _run_batch(self, batch):
        n = len(batch)
        # round up to a power of two so each shape runs O(log max_batch)
        # batch shapes, repeating the last image into the pad rows
        nb = 1
        while nb < n:
            nb *= 2
        xs = np.stack([p.x for p in batch] + [batch[-1].x] * (nb - n))
        t0 = time.monotonic()
        for p in batch:  # time from enqueue to dispatch (linger + backlog)
            self.phases["queue"].record(t0 - p.t_enq)
        try:
            ys = np.asarray(self.denoise_fn(xs))
            for i, p in enumerate(batch):
                p.out = ys[i]
        except Exception as e:  # noqa: BLE001 — propagate to every waiter
            for p in batch:
                p.err = e
        finally:
            # one device sample per DISPATCH (batched requests share it)
            self.phases["device"].record(time.monotonic() - t0)
            with self._meta:
                self.stats["batches"] += 1
                if n > 1:
                    self.stats["batched_requests"] += n
            for p in batch:
                p.done.set()

    def _loop(self):
        while True:
            batch = self._collect()
            if batch is None:
                if self._closed:
                    return
                continue
            self._run_batch(batch)

    def close(self):
        """Stop the dispatcher and fail queued waiters instead of abandoning
        them: every _Pending still in a queue gets a 503-mapped error (its
        client retries elsewhere), and requests arriving after close() are
        rejected at enqueue time."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            pending = [p for q in self._queues.values() for p in q]
            self._queues.clear()
            self._cv.notify_all()
        err = QueueFullError("service closed")
        for p in pending:
            p.err = err
            p.done.set()
        self._dispatcher.join(timeout=10.0)


def make_handler(service: DenoiseService, info: dict):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.split("?")[0] == "/healthz":
                payload = dict(info)
                payload.update(service.snapshot())
                self._send(200, json.dumps(payload).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path.split("?")[0] != "/denoise":
                self._send(404, b"not found", "text/plain")
                return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                self._send(400, b"empty body", "text/plain")
                return
            payload = self.rfile.read(length)
            # codec-free path: raw uint8 HWC body via Content-Type:
            # application/octet-stream + X-Shape: H,W,C; raw response via
            # Accept: application/octet-stream (X-Shape echoed back)
            raw_shape = None
            ctype_hdr = (self.headers.get("Content-Type") or "").lower()
            if ctype_hdr.startswith("application/octet-stream"):
                try:
                    raw_shape = tuple(
                        int(v) for v in
                        (self.headers.get("X-Shape") or "").split(","))
                    if len(raw_shape) != 3:
                        raise ValueError
                except ValueError:
                    self._send(400, b"octet-stream body needs X-Shape: H,W,C",
                               "text/plain")
                    return
            raw_out = "application/octet-stream" in (
                self.headers.get("Accept") or "").lower()
            try:
                out, out_shape = service.denoise_request(
                    payload, raw_shape=raw_shape, raw_out=raw_out)
            except BadRequestError as e:
                self._send(400, str(e).encode(), "text/plain")
                return
            except QueueFullError as e:
                self.send_response(503)
                self.send_header("Retry-After", "1")
                body = f"overloaded: {e}".encode()
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            except Exception as e:  # device OOM, dispatcher fault, ...
                # 500, not 400: a retrying client / balancer must treat an
                # internal inference fault as retriable, not a bad request
                self._send(500, f"denoise failed: {e}".encode(), "text/plain")
                return
            if raw_out:
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("X-Shape", ",".join(map(str, out_shape)))
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)
            else:
                self._send(200, out, "image/png")

    return Handler


def make_server(service: DenoiseService, info: dict, host: str = "127.0.0.1",
                port: int = 8900) -> ThreadingHTTPServer:
    """Bound server (port 0 picks a free port — used by tests)."""
    return ThreadingHTTPServer((host, port), make_handler(service, info))


def main(argv=None):
    from ..utils.cache import enable_compilation_cache

    enable_compilation_cache()
    p = argparse.ArgumentParser(description="Serve a denoising checkpoint over HTTP")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--arch", default="rdunet", choices=["rdunet", "diffusion"])
    p.add_argument("--base-filters", type=int, default=32)
    p.add_argument("--timesteps", type=int, default=20,
                   help="sampler steps of --arch diffusion")
    p.add_argument("--grayscale", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--engine", default="auto", choices=list(ENGINES))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--trusted-checkpoint", action="store_true")
    p.add_argument("--max-batch", type=int, default=8,
                   help="dynamic batching: coalesce up to N concurrent "
                        "same-shape requests into one dispatch (1 disables)")
    p.add_argument("--batch-wait-ms", type=float, default=5.0,
                   help="linger this long for a request burst before dispatch")
    p.add_argument("--max-queue", type=int, default=256,
                   help="reject (HTTP 503) when this many requests are queued")
    p.add_argument("--png-compress-level", type=int, default=1,
                   help="Pillow PNG compress_level for responses (0-9)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8900)
    p.add_argument("--tensor-parallel", action="store_true",
                   help="split layer channels across the ranks (torchrun): rank 0 serves, "
                        "the others compute each batch with it")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if args.tensor_parallel:
        from ..parallel.mesh import init_distributed

        # torchrun's environment; nccl for a card per rank, gloo for CPU ranks
        init_distributed("gloo" if device.type == "cpu" else "nccl")
    channels = 1 if args.grayscale else 3
    batching = args.max_batch > 1
    denoise_fn = build_denoiser(
        args.checkpoint, args.arch, args.base_filters, args.timesteps, channels=channels,
        bf16=args.bf16, engine=args.engine, trusted=args.trusted_checkpoint,
        batched=batching, device=device, tensor_parallel=args.tensor_parallel,
    )
    if args.tensor_parallel:
        from ..parallel.mesh import rank

        if rank() != 0:
            follow(denoise_fn, device)
            return
        denoise_fn = lead(denoise_fn, device)
    if batching:
        service = BatchingDenoiseService(
            denoise_fn, grayscale=args.grayscale,
            max_batch=args.max_batch, max_wait_ms=args.batch_wait_ms,
            max_queue=args.max_queue,
            png_compress_level=args.png_compress_level,
        )
    else:
        service = DenoiseService(denoise_fn, grayscale=args.grayscale,
                                 png_compress_level=args.png_compress_level)
    info = {
        "arch": args.arch,
        "base_filters": args.base_filters,
        "bf16": args.bf16,
        "max_batch": args.max_batch if batching else 1,
        "devices": [device_name(device)],
    }
    server = make_server(service, info, args.host, args.port)
    print(f"serving {args.arch} on http://{args.host}:{server.server_address[1]} "
          f"({info['devices'][0]})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
        service.close()
    finally:
        if args.tensor_parallel:
            denoise_fn.close()


def lead(denoise_fn, device):
    """Rank 0's ``denoise_fn`` under tensor parallelism: each call first
    broadcasts its input's shape and the input to the ``follow``ing ranks,
    which compute it with rank 0; ``fn.close()`` releases them."""
    import torch

    from ..parallel.mesh import broadcast

    def header(*dims):
        broadcast(torch.tensor([len(dims), *dims] + [0] * (4 - len(dims)), device=device), 0)

    def fn(x):
        arr = np.ascontiguousarray(np.asarray(x, np.float32))
        header(*arr.shape)
        broadcast(torch.from_numpy(arr).to(device), 0)
        return denoise_fn(arr)

    fn.close = header
    return fn


def follow(denoise_fn, device):
    """The other ranks under tensor parallelism: take part in every call of
    rank 0's ``lead`` function until it closes."""
    import torch

    from ..parallel.mesh import broadcast

    while True:
        shape = broadcast(torch.zeros(5, dtype=torch.long, device=device), 0).tolist()
        if shape[0] == 0:
            return
        x = broadcast(torch.empty(shape[1:1 + shape[0]], device=device), 0)
        denoise_fn(x.cpu().numpy())


def device_name(device) -> str:
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


if __name__ == "__main__":
    main()
