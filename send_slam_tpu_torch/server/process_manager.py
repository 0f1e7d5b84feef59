"""External backend process supervision.

The SendSlam.DockerHandler equivalent (docker_handler.ex): the
reference launches `docker run -d --rm --network=host` with
ORBSLAM3_*-prefixed env pass-through (:154-165, :195-205), polls
`docker inspect .State.Running` every 5 s (:118-151) and relies on the
supervisor to restart on death. Here the backend is a plain subprocess
(no docker needed — our engine is in-process by default, and an
external backend is just a command), with the same API surface:
start/stop/status/logs + auto-restart health polling; ORBSLAM3_*
env vars pass through with the prefix stripped, as the reference does.

The port's own copy of ``send_slam_tpu/server/process_manager.py``.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
import shlex
from typing import Deque, Dict, List, Optional

log = logging.getLogger(__name__)

ENV_PREFIX = "ORBSLAM3_"   # docker_handler.ex:199-205 pass-through


def env_passthrough(base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Merge app env + OS ORBSLAM3_* vars (prefix stripped)."""
    merged = dict(base or {})
    for k, v in os.environ.items():
        if k.startswith(ENV_PREFIX):
            merged[k[len(ENV_PREFIX):]] = v
    return merged


class ProcessManager:
    def __init__(self, command: str,
                 env: Optional[Dict[str, str]] = None,
                 auto_restart: bool = True,
                 poll_interval: float = 5.0,
                 log_lines: int = 500):
        self.command = command
        self.env = env_passthrough(env)
        self.auto_restart = auto_restart
        self.poll_interval = poll_interval
        self._proc: Optional[asyncio.subprocess.Process] = None
        self._logs: Deque[str] = collections.deque(maxlen=log_lines)
        self._stop = asyncio.Event()
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        self._stop.clear()
        await self._spawn()
        self._task = asyncio.create_task(self._poll())

    async def _spawn(self) -> None:
        full_env = dict(os.environ)
        full_env.update(self.env)
        self._proc = await asyncio.create_subprocess_exec(
            *shlex.split(self.command),
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.STDOUT,
            env=full_env)
        asyncio.create_task(self._pump_logs(self._proc))
        log.info("backend process started: pid=%s", self._proc.pid)

    async def _pump_logs(self, proc) -> None:
        while True:
            line = await proc.stdout.readline()
            if not line:
                return
            self._logs.append(line.decode(errors="replace").rstrip())

    async def _poll(self) -> None:
        """Health poll + restart (docker_handler.ex:118-151 — but with
        the restart gap the reference left open actually closed: a dead
        backend is relaunched here, not just observed)."""
        backoff = 1.0
        while not self._stop.is_set():
            await asyncio.sleep(self.poll_interval)
            if self._proc is None or self._proc.returncode is None:
                backoff = 1.0
                continue
            log.warning("backend died (rc=%s)", self._proc.returncode)
            if not self.auto_restart:
                return
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, 30.0)
            try:
                await self._spawn()
            except Exception:
                log.exception("backend respawn failed")

    def status(self) -> str:
        if self._proc is None:
            return "not_started"
        return "running" if self._proc.returncode is None \
            else f"exited({self._proc.returncode})"

    def logs(self, tail: int = 50) -> List[str]:
        return list(self._logs)[-tail:]

    async def stop(self) -> None:
        self._stop.set()
        if self._task:
            self._task.cancel()
        if self._proc and self._proc.returncode is None:
            self._proc.terminate()
            try:
                await asyncio.wait_for(self._proc.wait(), 5.0)
            except asyncio.TimeoutError:
                self._proc.kill()
