"""Tagged point-to-point message transport (host-side).

Counterpart of ``mpit_tpu/transport``: the reference's PS protocol ran on
``MPI_Send/Recv/Isend/Irecv`` with message *tags* and ``ANY_SOURCE``
receives; these are those semantics on the host. Two implementations
behind one interface:

- :class:`InProcTransport` — ranks are threads in one process, delivery
  through an in-memory broker (or the C++ one, :mod:`mpit_tpu_torch.native`);
- :class:`SocketTransport` — ranks are processes, delivery over TCP with
  the reference's frames (:mod:`~mpit_tpu_torch.transport.wire`), so a
  port rank and a reference rank talk to each other.

:class:`ChaosTransport` wraps either with the reference's seeded fault
schedule.

Ordering guarantee (matching MPI): messages between a fixed (src, dst) pair
with the same tag are received in send order; ANY_SOURCE/ANY_TAG receives
scan in arrival order.
"""

from mpit_tpu_torch.transport.base import (  # noqa: F401
    ANY_SOURCE,
    ANY_TAG,
    Message,
    RecvTimeout,
    Transport,
)
from mpit_tpu_torch.transport.chaos import (  # noqa: F401
    ChaosConfig,
    ChaosTransport,
    CorruptedPayload,
    FaultEvent,
    FaultLog,
    config_from_env,
    wrap_transports,
)
from mpit_tpu_torch.transport.inproc import Broker, InProcTransport  # noqa: F401
from mpit_tpu_torch.transport.socket_transport import (  # noqa: F401
    WIRE_PICKLE_PROTOCOL,
    SocketTransport,
)
from mpit_tpu_torch.transport.wire import (  # noqa: F401
    WIRE_FORMAT_VERSION,
    QuantArray,
    WireDecodeError,
    dequantize,
    quantize,
)
