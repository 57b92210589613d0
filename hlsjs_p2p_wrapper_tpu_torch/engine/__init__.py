"""Host-side modules of the reference's ``engine/`` package, copied, not
imported: what the port's device model needs, and the real-protocol
plane (the agent, the tracker, the loopback and TCP wires).  Nothing is
imported here, so importing the package stays light."""
