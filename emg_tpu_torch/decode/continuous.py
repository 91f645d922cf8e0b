"""Continuous-batching beam-search serving.

Counterpart of ``emg_tpu/decode/continuous.py``. ``DeviceBeamSearcher.
search_many`` runs its utterances in lock-step, so a launch ends when its
slowest search does. This server keeps a fixed pool of L lanes (the step
body's utterance axis U) and advances them ``chunk`` beam steps at a time;
when a lane's search is done, its result is taken and the next queued
utterance starts in that lane, so no lane waits for a straggler.

One advance is ``chunk`` steps of the searcher's body with each lane at its
own position (``_step(lockstep=False)``): a lane steps while it can make
progress (alive rows before its ``max_len`` and the cache's end), with no
early exit inside the chunk; on the card the chunk is one CUDA graph per
(L, chunk), run by the searcher's ``LoopRunner`` (eagerly on the CPU).
After it, the host reads the lanes' done flags once and, if a lane
finished, fetches every lane's winner once. Then, outside the graph and in
place in its buffers, each finished lane is refilled with the next request
(``DeviceBeamSearcher._refill_lane``: its cross K/V, source mask and
``max_len``, fresh hypotheses, its cache rows zeroed and its cache
selection the identity), or retired. A retired lane is inert: it makes no
progress, so nothing reaches its finished buffer.

An odd ``chunk`` leaves the beam's ping-pong caches in their second
buffers; the runner then replays two graphs in turn (``decode/graphs.py``),
so that no advance copies a cache and a refill zeroes the buffer that the
next step reads.
"""

from __future__ import annotations

import functools
from typing import Iterable, List, Tuple

import numpy as np
import torch

from emg_tpu_torch.data.batching import PackedBatch
from emg_tpu_torch.decode.device_beam import DeviceBeamSearcher


class ContinuousBeamServer:
    def __init__(self, searcher: DeviceBeamSearcher, lanes: int = 8, chunk: int = 16):
        """``lanes``: searches resident on the device at once. ``chunk``:
        beam steps an advance (a smaller one refills sooner and reads the
        card more often)."""
        if lanes < 1 or chunk < 1:
            raise ValueError(f"a server needs a lane and a step an advance, not {lanes}, {chunk}")
        self.searcher = searcher
        self.lanes = lanes
        self.chunk = chunk
        # over the server's life: advances, fetches of the lanes' winners,
        # lanes refilled with a new request
        self.advances = self.fetches = self.refills = 0

    def serve(self, requests: Iterable[Tuple[PackedBatch, int]]
              ) -> List[Tuple[np.ndarray, float, List[str]]]:
        """Decode (batch, target length in tokens) requests; returns each
        one's (history, score, words), as ``DeviceBeamSearcher.search``
        does, in request order. Every batch must give the searcher's
        geometry (bucket upstream, as for ``search_many``)."""
        s = self.searcher
        queue = list(requests)
        n = len(queue)
        if n == 0:
            return []
        L = min(self.lanes, n)
        results: List = [None] * n
        body = functools.partial(s._step, lockstep=False)
        st = None

        def init(old):
            # the first advance starts the pool; later ones go on from it
            return st if st is not None else s._init_state(kvs, mask, max_len, old)

        with torch.inference_mode():
            kvs, mask = s._stack_ctx([s._make_ctx(batch) for batch, _ in queue[:L]])
            max_len = torch.as_tensor([int(t) + s.cfg.extra_steps for _, t in queue[:L]],
                                      dtype=torch.int64, device=s.device)
            lane_req = list(range(L))  # the request in each lane; -1: retired
            next_req, active = L, L
            while active:
                st = s.runner.run(("continuous", L, self.chunk), init, body, blocks=1, k=self.chunk)
                self.advances += 1
                done = s.lanes_done(st).cpu().numpy()
                finished = [lane for lane in range(L) if done[lane] and lane_req[lane] >= 0]
                if not finished:
                    continue
                best = s._best(st)
                self.fetches += 1
                for lane in finished:
                    results[lane_req[lane]] = s._format(*[a[lane] for a in best])
                    if next_req < n:
                        batch, target_len = queue[next_req]
                        s._refill_lane(st, lane, s._make_ctx(batch),
                                       int(target_len) + s.cfg.extra_steps)
                        lane_req[lane] = next_req
                        next_req += 1
                        self.refills += 1
                    else:
                        lane_req[lane] = -1
                        active -= 1
        return results
