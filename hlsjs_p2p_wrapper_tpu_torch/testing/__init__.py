"""Test infrastructure of the port: moving state between the reference
and the port (``convert``) and the committed reference run
(``reference_run.npz``, written by ``tools/torch_port_fixture.py``)."""

import os

#: the reference's final offload and rebuffer ratio at a fixed shape,
#: for holding the port on a machine without JAX
REFERENCE_RUN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "reference_run.npz")
