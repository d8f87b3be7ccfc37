"""Fleet-state serving plane: a watch-cache materialized view with resumable
snapshot/delta subscriptions over an encode-once broadcast core (the JAX
package's ``serve/``)."""

from k8s_watcher_tpu_torch.serve.broadcast import BroadcastLoop
from k8s_watcher_tpu_torch.serve.server import ServePlane, ServeServer
from k8s_watcher_tpu_torch.serve.view import (
    CODEC_JSON,
    CODEC_MSGPACK,
    CODECS,
    DELETE,
    GONE,
    INVALID,
    JSON_CONTENT_TYPE,
    MSGPACK_CONTENT_TYPE,
    OK,
    UPSERT,
    Delta,
    FleetView,
    FrameReadResult,
    ReadResult,
    Subscription,
    SubscriptionHub,
    chunk_frame,
    frame_body,
    frame_payload,
    msgpack_available,
)

__all__ = [
    "CODEC_JSON",
    "CODEC_MSGPACK",
    "CODECS",
    "DELETE",
    "GONE",
    "INVALID",
    "JSON_CONTENT_TYPE",
    "MSGPACK_CONTENT_TYPE",
    "OK",
    "UPSERT",
    "BroadcastLoop",
    "Delta",
    "FleetView",
    "FrameReadResult",
    "ReadResult",
    "ServePlane",
    "ServeServer",
    "Subscription",
    "SubscriptionHub",
    "chunk_frame",
    "frame_body",
    "frame_payload",
    "msgpack_available",
]
