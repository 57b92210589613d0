# A copy of the reference's core/wrapper.py
# (hlsjs_p2p_wrapper_tpu/core/wrapper.py): the same names, formats and
# bytes; the imports point at the port's own modules; the default agent is
# imported from its module, so the port's engine/__init__.py stays light.
"""Public wrapper facade.

Rebuild of ``HlsjsP2PWrapper`` (lib/hlsjs-p2p-wrapper.js:6-44): pure
delegation onto the session manager plus live passthrough properties
onto the (lazily created) agent.  As in the reference, touching
``stats`` or the toggles before a session exists raises — observable
API behavior SURVEY.md §2.5 says to match or consciously improve; we
improve it to a typed :class:`SessionError` with a clear message.
"""

from __future__ import annotations

from .errors import SessionError
from .session import P2PSessionManager
from ..version import get_version


class P2PWrapper:
    """DI facade: construct with your player class; the full P2P agent
    is the default engine (a CDN-only engine can be injected for
    swarm-less deployments)."""

    def __init__(self, player_constructor=None, peer_agent_constructor=None,
                 clock=None):
        if peer_agent_constructor is None:
            from ..engine.p2p_agent import P2PAgent
            peer_agent_constructor = P2PAgent
        wrapper = P2PSessionManager(player_constructor,
                                    peer_agent_constructor, clock=clock)
        self._wrapper = wrapper
        self.create_player = wrapper.create_player
        self.create_media_engine = wrapper.create_media_engine
        self.create_sr_module = wrapper.create_sr_module
        self.P2PLoader = wrapper.P2PLoader

    def _agent(self):
        agent = self._wrapper.peer_agent_module
        if agent is None:
            raise SessionError("No active session: agent does not exist yet")
        return agent

    @property
    def stats(self) -> dict:
        """{cdn, p2p, upload, peers} (lib/hlsjs-p2p-wrapper.js:14-18)."""
        return self._agent().stats

    @property
    def p2p_download_on(self) -> bool:
        return self._agent().p2p_download_on

    @p2p_download_on.setter
    def p2p_download_on(self, on: bool) -> None:
        self._agent().p2p_download_on = on

    @property
    def p2p_upload_on(self) -> bool:
        return self._agent().p2p_upload_on

    @p2p_upload_on.setter
    def p2p_upload_on(self, on: bool) -> None:
        self._agent().p2p_upload_on = on

    @property
    def has_session(self) -> bool:
        return self._wrapper.has_session()

    @property
    def peer_agent(self):
        """The live agent instance, or None before a session starts —
        for harnesses/diagnostics that need engine internals without
        reaching through the session manager."""
        return self._wrapper.peer_agent_module

    version = staticmethod(get_version)
