"""Waiting for the device, the same on the card and (in the tests) the CPU."""

from __future__ import annotations

import collections

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Queue:
    """Keeps one call queued on the device behind the one running:
    :meth:`push` after issuing a call waits for the call before it."""

    def __init__(self, device: torch.device) -> None:
        self.device, self.events = device, collections.deque()

    def push(self) -> None:
        if self.device.type != "cuda":
            return
        event = torch.cuda.Event()
        event.record()
        self.events.append(event)
        while len(self.events) > 1:
            self.events.popleft().synchronize()
