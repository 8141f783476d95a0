"""Tagged point-to-point message transport (host-side).

Counterpart of ``mpit_tpu/transport``: the reference's PS protocol ran on
``MPI_Send/Recv/Isend/Irecv`` with message *tags* and ``ANY_SOURCE``
receives; these are those semantics on the host, between threads. The
port has the in-process transport (:class:`Broker`, :class:`InProcTransport`)
and the part of the wire module the PS roles import. The socket transport,
the frame codec and the chaos injector come with ROADMAP.md item A7c.

Ordering guarantee (matching MPI): messages between a fixed (src, dst) pair
with the same tag are received in send order; ANY_SOURCE/ANY_TAG receives
scan in arrival order.
"""

from mpit_tpu_torch.transport.base import (  # noqa: F401
    ANY_SOURCE,
    ANY_TAG,
    CorruptedPayload,
    Message,
    RecvTimeout,
    Transport,
)
from mpit_tpu_torch.transport.inproc import Broker, InProcTransport  # noqa: F401
from mpit_tpu_torch.transport.wire import (  # noqa: F401
    QuantArray,
    WireDecodeError,
    dequantize,
    quantize,
)
