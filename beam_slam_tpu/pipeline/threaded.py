"""Threaded pipeline: per-sensor spinner threads + a free-running optimizer
thread — the model-parallel runtime of the reference (SURVEY.md §2.7 /
component #71: every fuse AsyncSensorModel runs its callback queue on its
own spinner thread, and the fixed-lag smoother solves on a dedicated
optimizer thread, fixed_lag_smoother.cpp:166-311).

Shape of the same design here:

* one ``queue.Queue`` + daemon spinner thread per sensor stream (imu /
  lidar / camera / pose). Heavy per-scan device work (feature extraction,
  registration, LK tracking) runs on the owning spinner; the GIL is
  released during XLA execution, so streams genuinely overlap on those
  sections.
* the smoother serializes all graph access on an internal RLock (the
  pending-transaction mutex of the reference), and the optimizer thread
  ticks it at ``optimization_period`` — with ``async_solve`` the solve
  itself is dispatched to the device without blocking the lock.
* cross-model calls (trigger → IMU constraint generation, frame-init pose
  queries, the ignition fan-out) are serialized on one model lock,
  mirroring the reference's trigger-topic indirection.

Sensor feeds (``on_imu``/``on_scan``/…) are non-blocking: a full queue
drops the OLDEST event (driver semantics — stale sensor data is worthless)
and counts the drop.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

from beam_slam_tpu.models.lidar_odometry import SlamChunk
from beam_slam_tpu.pipeline.config import LocalMapperConfig
from beam_slam_tpu.pipeline.local_mapper import LocalMapper

_STREAMS = ("imu", "lidar", "camera", "pose")


class ThreadedLocalMapper(LocalMapper):
    """Drop-in LocalMapper whose sensor callbacks enqueue onto per-stream
    spinner threads. Call :meth:`start` to spin up, :meth:`stop` to join.
    ``join()`` blocks until every queued event has been processed (test
    and batch-replay barrier)."""

    def __init__(self, config: LocalMapperConfig = LocalMapperConfig(),
                 chunk_cb: Optional[Callable[[SlamChunk], None]] = None,
                 queue_size: int = 4096,
                 optimizer_thread: bool = True):
        self._model_lock = threading.RLock()
        # set only after the FULL ignition fan-out: `init.initialized` flips
        # before the models are unblocked (slam_initialization.py:295 vs
        # :305), so unlocked fast paths must key on this flag instead
        self._ignited = False
        super().__init__(config, chunk_cb)
        self._queues = {s: queue.Queue(maxsize=queue_size) for s in _STREAMS}
        self._unfinished = {s: 0 for s in _STREAMS}
        self._count_lock = threading.Lock()
        self.dropped = {s: 0 for s in _STREAMS}
        self.errors = {s: 0 for s in _STREAMS}
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._spin, args=(s,), daemon=True,
                             name=f"spinner-{s}") for s in _STREAMS]
        self._use_optimizer_thread = optimizer_thread
        if optimizer_thread:
            self._threads.append(threading.Thread(
                target=self._optimize_loop, daemon=True, name="optimizer"))
        self._started = False
        self._route_graph_updates()

    def _route_graph_updates(self):
        """Deliver each model's graph-update notification on that model's
        own spinner (fuse delivers onGraphUpdate to the plugin's callback
        queue) instead of inline on the optimizer thread — otherwise the
        optimizer would mutate lidar/visual model state concurrently with
        their spinners."""
        def stream_of(cb):
            owner = getattr(cb, "__self__", None)
            if owner is None:
                return None
            if owner is self.io or owner is getattr(self.io, "model", None):
                return "imu"
            if owner is self.lo or owner is getattr(
                    self.lo, "registration", None):
                return "lidar"
            if owner is self.vo:
                return "camera"
            return None

        routed = []
        for cb in self.smoother._on_update:
            s = stream_of(cb)
            if s is None:
                routed.append(cb)
            elif s == "imu":
                # imu-model state is shared with trigger/frame-init callers
                # → run under the model lock
                def locked_cb(sm, cb=cb):
                    with self._model_lock:
                        cb(sm)
                routed.append(lambda sm, f=locked_cb:
                              self._enqueue("imu", (f, (sm,))))
            else:
                routed.append(lambda sm, cb=cb, s=s:
                              self._enqueue(s, (cb, (sm,))))
        self.smoother._on_update = routed

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ThreadedLocalMapper":
        if not self._started:
            self._started = True
            for t in self._threads:
                t.start()
        return self

    def stop(self):
        """Drain, final tick, join all threads.

        After the spinners drain, tick the smoother until quiescent: under
        CPU contention the wall-clock optimizer thread may have run fewer
        cycles than the synchronous pipeline would, leaving transactions
        pending — shutdown must consume them (the reference's optimizer
        likewise drains its queue on stop). This is what made the
        threaded-vs-sync parity test load-flaky in round 2: the threaded
        run stopped mid-optimization, not with different answers."""
        if not self._started:
            return
        self.join()
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30.0)
        self._started = False
        with self._model_lock:
            # full LocalMapper.flush: drains the pipelined-registration
            # device queue (factors still in flight) AND the async solve
            self.flush()
            for _ in range(64):  # bounded: each pass consumes the queue
                if not self.smoother._pending:
                    break
                self.smoother.run_once()
                self.smoother.flush()

    def join(self, timeout: Optional[float] = None):
        """Wait until every enqueued sensor event has been processed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for s in _STREAMS:
            while True:
                with self._count_lock:
                    done = self._unfinished[s] == 0
                if done:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"stream {s} still has work")
                time.sleep(0.002)

    # -- spinners -------------------------------------------------------------
    def _enqueue(self, stream: str, item):
        q = self._queues[stream]
        while True:
            try:
                q.put_nowait(item)
                with self._count_lock:
                    self._unfinished[stream] += 1
                return
            except queue.Full:
                try:
                    q.get_nowait()  # drop oldest
                    with self._count_lock:
                        self._unfinished[stream] -= 1
                    self.dropped[stream] += 1
                except queue.Empty:
                    pass

    def _spin(self, stream: str):
        q = self._queues[stream]
        while not self._stop.is_set():
            try:
                item = q.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                fn, args = item
                fn(*args)
            except Exception:  # noqa: BLE001 — keep the spinner alive
                # A failing callback must not kill the stream (fuse callback
                # queues likewise survive a throwing plugin callback): count
                # it, log the first few, keep spinning.
                self.errors[stream] += 1
                if self.errors[stream] <= 3:
                    import traceback
                    traceback.print_exc()
            finally:
                with self._count_lock:
                    self._unfinished[stream] -= 1

    def _optimize_loop(self):
        period = self.cfg.smoother_config().optimization_period
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(period)

    # -- sensor feeds (non-blocking producers) --------------------------------
    def on_imu(self, t, w, a):
        self._enqueue("imu", (self._imu_event, (t, w, a)))

    def on_scan(self, t, grid) -> bool:
        self._enqueue("lidar", (self._scan_event, (t, grid)))
        return True

    def on_image(self, t, image) -> bool:
        self._enqueue("camera", (self._image_event, (t, image)))
        return True

    def on_camera_measurement(self, meas) -> bool:
        self._enqueue("camera", (self._camera_event, (meas,)))
        return True

    def on_pose(self, t, q_wb, p_wb) -> bool:
        self._enqueue("pose", (self._pose_event, (t, q_wb, p_wb)))
        return True

    # -- spinner-side handlers -------------------------------------------------
    # IMU + init + ignition fan-out share the model lock; steady-state lidar/
    # camera processing runs unlocked on its own spinner (its cross-model
    # calls come back through the locked _trigger/_frame_init below).
    def _imu_event(self, t, w, a):
        with self._model_lock:
            super().on_imu(t, w, a)

    def _scan_event(self, t, grid):
        if not self._ignited:
            with self._model_lock:
                if not self._ignited:
                    super().on_scan(t, grid)
                    return
        super().on_scan(t, grid)

    def _image_event(self, t, image):
        if self.tracker is None:
            return
        meas = self.tracker.process_image(t, image)
        self._camera_event(meas)

    def _camera_event(self, meas):
        if not self._ignited:
            with self._model_lock:
                if not self._ignited:
                    super().on_camera_measurement(meas)
                    return
        super().on_camera_measurement(meas)

    def _pose_event(self, t, q_wb, p_wb):
        with self._model_lock:
            super().on_pose(t, q_wb, p_wb)

    # -- cross-model sections (called from lidar/camera spinners) -------------
    def _trigger(self, t):
        with self._model_lock:
            super()._trigger(t)

    def _frame_init(self, t):
        with self._model_lock:
            return super()._frame_init(t)

    def _on_initialized(self, result):
        with self._model_lock:
            super()._on_initialized(result)
            self._ignited = True

    # -- optimizer tick --------------------------------------------------------
    def tick(self):
        # Wait for the in-flight solve OUTSIDE the model lock: the round-5
        # threaded/rt session measured RTF 0.18 because the optimizer
        # thread held the lock through its blocking harvest and starved
        # every sensor spinner (they re-enter via _trigger/_frame_init).
        # Only this optimizer thread harvests, so the pre-wait is safe.
        inflight = self.smoother._inflight
        if inflight is not None:
            import jax
            try:
                jax.block_until_ready(inflight[0])
            except Exception:  # noqa: BLE001 — harvest will surface errors
                pass
        # the smoother's notify fan-out re-enters the IMU model
        # (update_from_graph) — take the model lock for the actual tick
        with self._model_lock:
            return super().tick()

    def reset(self):
        self.stop()
        with self._model_lock:
            super().reset()
