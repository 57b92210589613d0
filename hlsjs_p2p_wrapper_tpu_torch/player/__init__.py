"""The in-tree media engine of the real-protocol plane: the manifest
builders (``manifest``) and the full-dynamics ``SimPlayer`` (``sim``),
copied from the reference's ``player/``.  Nothing is imported here, so
importing the package stays light."""
