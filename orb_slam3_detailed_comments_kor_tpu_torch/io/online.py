"""Online sensor-node runtime: topic queues + synchronization loop.

The port's own copy of ``orb_slam3_detailed_comments_kor_tpu/io/
online.py``, driving this package's ``SlamSystem``. Analog of the reference's ROS nodes
(``Examples/ROS/ORB_SLAM3/src/ros_{mono,stereo,rgbd,mono_inertial,
stereo_inertial}.cc``): each node subscribes to sensor topics, buffers
messages in thread-safe queues (``ImuGrabber``/``ImageGrabber``) and a sync
thread (``ImageGrabber::SyncWithImu``) pairs left/right frames by timestamp,
waits until the IMU stream covers the image time, and feeds the SLAM system.

There is no ROS dependency here: ``publish_*`` are plain thread-safe calls a
driver (socket reader, camera SDK callback, or a dataset replayer) invokes
from any thread. The sync policy mirrors ``ros_stereo_inertial.cc``:

- left/right are paired when ``|tL - tR| <= max_time_diff``; the older
  unmatched frame is dropped;
- an image is processed only once an IMU sample newer than the image
  timestamp has arrived (so the IMU window for the frame is complete);
- if the node falls behind (queue deeper than ``max_queue``), the oldest
  frames are dropped — an online node must track the present, not the past.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

__all__ = ["ImuQueue", "ImageQueue", "OnlineNode"]


class ImuQueue:
    """Thread-safe IMU buffer (``ImuGrabber`` in ``ros_stereo_inertial.cc``)."""

    def __init__(self) -> None:
        self._q: Deque[Tuple[float, np.ndarray, np.ndarray]] = deque()
        self._lock = threading.Lock()

    def push(self, t: float, acc, gyro) -> None:
        with self._lock:
            self._q.append((float(t), np.asarray(acc, np.float32),
                            np.asarray(gyro, np.float32)))

    def newest_time(self) -> Optional[float]:
        with self._lock:
            return self._q[-1][0] if self._q else None

    def pop_until(self, t: float) -> List[Tuple[float, np.ndarray, np.ndarray]]:
        """Drain all samples with timestamp <= t (the frame's IMU window)."""
        out = []
        with self._lock:
            while self._q and self._q[0][0] <= t:
                out.append(self._q.popleft())
        return out


class ImageQueue:
    """Thread-safe image buffer (``ImageGrabber`` queues)."""

    def __init__(self, max_queue: int = 8) -> None:
        self._q: Deque[Tuple[float, np.ndarray]] = deque()
        self._lock = threading.Lock()
        self.max_queue = max_queue
        self.n_dropped = 0

    def push(self, t: float, img) -> None:
        with self._lock:
            self._q.append((float(t), img))
            while len(self._q) > self.max_queue:
                self._q.popleft()
                self.n_dropped += 1

    def front_time(self) -> Optional[float]:
        with self._lock:
            return self._q[0][0] if self._q else None

    def pop(self) -> Optional[Tuple[float, np.ndarray]]:
        with self._lock:
            return self._q.popleft() if self._q else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


class OnlineNode:
    """Sensor-topic front door for a :class:`SlamSystem`.

    Modes mirror the six reference ROS nodes: ``mono``, ``stereo``,
    ``rgbd``, ``mono_inertial``, ``stereo_inertial``.

    Usage::

        node = OnlineNode(slam, mode="stereo_inertial")
        node.start()
        # from sensor callbacks (any thread):
        node.publish_imu(t, acc, gyro)
        node.publish_left(t, img_l); node.publish_right(t, img_r)
        ...
        node.stop()   # drains queues, flushes deferred decisions
    """

    MODES = ("mono", "stereo", "rgbd", "mono_inertial", "stereo_inertial")

    def __init__(self, system, mode: str = "stereo_inertial",
                 max_time_diff: float = 0.01, max_queue: int = 8,
                 idle_sleep: float = 1e-3) -> None:
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, got {mode!r}")
        self.system = system
        self.mode = mode
        self.max_time_diff = float(max_time_diff)
        self.idle_sleep = float(idle_sleep)
        self.imu = ImuQueue()
        self.left = ImageQueue(max_queue)
        self.right = ImageQueue(max_queue)  # depth queue in rgbd mode
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self.n_processed = 0
        self._err: Optional[BaseException] = None

    # -- topics ---------------------------------------------------------
    def publish_imu(self, t: float, acc, gyro) -> None:
        self.imu.push(t, acc, gyro)

    def publish_left(self, t: float, img) -> None:
        self.left.push(t, img)

    def publish_right(self, t: float, img) -> None:
        self.right.push(t, img)

    publish_image = publish_left          # mono / rgbd color topic
    publish_depth = publish_right         # rgbd depth topic

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "OnlineNode":
        self._running = True
        self._thread = threading.Thread(target=self._spin, daemon=True,
                                        name="OnlineNode.sync")
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the sync thread; with ``drain``, first wait for the queues
        to empty (bounded by ``timeout``) so no published frame is lost."""
        if drain and self._thread is not None:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline and self._has_pair():
                time.sleep(self.idle_sleep)
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        if self._err is not None:
            raise self._err
        flush = getattr(self.system, "flush_decisions", None)
        if flush is not None:
            flush()

    # -- sync loop (ImageGrabber::SyncWithImu) ---------------------------
    def _has_pair(self) -> bool:
        if self.mode in ("mono", "mono_inertial"):
            return len(self.left) > 0
        return len(self.left) > 0 and len(self.right) > 0

    def _spin(self) -> None:
        try:
            while self._running:
                if not self._step():
                    time.sleep(self.idle_sleep)
        except BaseException as e:  # surfaced on stop()
            self._err = e
            self._running = False

    def _step(self) -> bool:
        """Process at most one frame; returns False when idle."""
        two_streams = self.mode in ("stereo", "stereo_inertial", "rgbd")
        t_l = self.left.front_time()
        if t_l is None:
            return False
        if two_streams:
            t_r = self.right.front_time()
            if t_r is None:
                return False
            # drop the older unmatched frame until the pair aligns
            while t_r is not None and t_r < t_l - self.max_time_diff:
                self.right.pop()
                t_r = self.right.front_time()
            while t_l is not None and t_r is not None and \
                    t_l < t_r - self.max_time_diff:
                self.left.pop()
                t_l = self.left.front_time()
            if t_l is None or t_r is None:
                return False
        if self.mode.endswith("inertial"):
            newest = self.imu.newest_time()
            if newest is None or newest <= t_l:
                return False  # IMU window for this frame not complete yet
        frame_l = self.left.pop()
        if frame_l is None:
            return False
        t, img_l = frame_l
        sys = self.system
        if self.mode == "mono":
            sys.track_mono(img_l, t)
        elif self.mode == "mono_inertial":
            sys.track_mono_inertial(img_l, t, self.imu.pop_until(t))
        elif self.mode == "rgbd":
            fr = self.right.pop()
            sys.track_rgbd(img_l, fr[1], t)
        elif self.mode == "stereo":
            fr = self.right.pop()
            sys.track_stereo(img_l, fr[1], t)
        else:  # stereo_inertial
            fr = self.right.pop()
            sys.track_stereo_inertial(img_l, fr[1], t, self.imu.pop_until(t))
        self.n_processed += 1
        return True
