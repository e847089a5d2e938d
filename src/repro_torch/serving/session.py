"""Conversation sessions (paper Scenario 1: a conversation started on the
laptop continues in the car / on the phone / via cloud fallback).

A Session tracks the multi-turn history, the privacy level of the island
currently holding the raw context (``prev_privacy``), and reuses one
placeholder store so entity mappings stay stable across turns of the same
conversation (paper Sec VII-B: per-session bidirectional mapping)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.waves import Request


@dataclass
class Session:
    user: str = "user0"
    priority: str = "secondary"
    history: list = field(default_factory=list)      # raw (trusted) turns
    prev_privacy: float = 1.0
    islands_visited: list = field(default_factory=list)

    def request(self, query: str, **kw) -> Request:
        return Request(query=query, history=tuple(self.history),
                       priority=kw.pop("priority", self.priority),
                       user=self.user, prev_privacy=self.prev_privacy, **kw)


class SessionManager:
    def __init__(self, engine):
        self.engine = engine
        self.sessions: dict[str, Session] = {}

    def get(self, session_id: str, **kw) -> Session:
        return self.sessions.setdefault(session_id, Session(**kw))

    def chat(self, session_id: str, query: str, max_new_tokens=8, **kw):
        """Route + execute one turn; maintain history and trust level.

        Works against both frontends: the per-request ``InferenceEngine``
        (submit returns the Response directly) and the ``TickOrchestrator``
        (submit only enqueues — use its blocking ``submit_sync``, which
        ticks the scheduling loop until this turn resolves)."""
        s = self.get(session_id)
        submit = getattr(self.engine, "submit_sync", self.engine.submit)
        resp = submit(s.request(query, **kw), max_new_tokens)
        if resp is None:
            return None
        s.history.append(query)
        s.history.append(resp.text)
        s.islands_visited.append(resp.island_id)
        # context now also lives on the serving island: the NEXT turn's
        # trust-boundary check compares against the minimum privacy seen
        isl = self.engine.registry.get(resp.island_id)
        if not resp.sanitized:
            # raw context reached this island
            s.prev_privacy = min(s.prev_privacy, isl.privacy) \
                if isl.tier != 1 else s.prev_privacy
        return resp
