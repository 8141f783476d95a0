"""Serving fleet: request router + replica set + self-driving control;
the port's counterpart of ``mpit_tpu/fleet`` (the same names, the same
wire lanes and journal records), over the port's ``Server`` on the card
(or the CPU with ``device="cpu"``).

The deployment half of "serving under traffic" (the measurement half is
:mod:`mpit_tpu_torch.loadgen`): a **router** admits loadgen requests and
dispatches them to N **replica** processes — each a
:class:`mpit_tpu_torch.models.serving.Server` behind a transport dispatch
loop — by least-loaded or power-of-two-choices over the queue-depth
each replica reports, journaling every request's routing lifecycle
(``req_route``/``req_redispatch``) so a kill-time audit can prove no
admitted request was lost. Replicas pull versioned weights from a
:class:`~mpit_tpu_torch.fleet.weights.WeightPublisher` (quantized bf16/int8
over the same wire the PS PARAM path uses — error feedback stays OFF,
serving is read-only) and stamp every reply with the
``serving_weights_version`` they decoded with, making rolling refreshes
auditable. A **controller** closes the loop: it consumes the alert
stream (``slo_burn``/``dead_rank``/``straggler``) and live snapshots to
spawn/retire replicas and shed load at admission.

Wire tags 11–15 (``TAG_ROUTE``..``TAG_FLEET_STOP``) live in
:mod:`~mpit_tpu_torch.fleet.replica`; both roles carry protocol-role markers,
so MPT008 pairs their alphabets, the wire-schema lock pins their payload
shapes (MPT016–018), and ``analysis mcheck`` explores the ``fleet-route``
model (MPT019: no admitted request both lost and unacked under a single
replica kill). docs/SERVING.md has the walkthrough; ``python -m mpit_tpu_torch.fleet``
runs it.
"""

from mpit_tpu_torch.fleet.audit import audit_lifecycle, format_audit
from mpit_tpu_torch.fleet.controller import Action, FleetController, decide
from mpit_tpu_torch.fleet.harness import FleetHarness, FleetReport
from mpit_tpu_torch.fleet.replica import (
    TAG_FLEET_STOP,
    TAG_REPLY,
    TAG_ROUTE,
    TAG_WEIGHT_PUSH,
    TAG_WEIGHT_SUB,
    ReplicaServer,
)
from mpit_tpu_torch.fleet.router import Router, choose_replica
from mpit_tpu_torch.fleet.weights import (
    StaticWeightSource,
    WeightPublisher,
    flatten_named,
    unflatten_like,
)

__all__ = [
    "TAG_ROUTE",
    "TAG_REPLY",
    "TAG_WEIGHT_SUB",
    "TAG_WEIGHT_PUSH",
    "TAG_FLEET_STOP",
    "ReplicaServer",
    "Router",
    "choose_replica",
    "StaticWeightSource",
    "WeightPublisher",
    "flatten_named",
    "unflatten_like",
    "FleetHarness",
    "FleetReport",
    "Action",
    "FleetController",
    "decide",
    "audit_lifecycle",
    "format_audit",
]
