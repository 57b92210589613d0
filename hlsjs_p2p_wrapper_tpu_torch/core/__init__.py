"""Player-side modules of the reference's ``core/`` package, copied, not
imported: the ABR estimator the device model shares, the segment key,
and the player side of the real-protocol plane (clock, events, loader,
session, facade).  Nothing is imported here, so importing the package
stays light."""
