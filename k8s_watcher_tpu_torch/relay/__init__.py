"""The relay tier (the JAX package's ``relay/``): a serve node that mirrors
one upstream ``?watch=1`` stream through the federation client's raw-bytes
passthrough and re-broadcasts the upstream's encoded frames as they are,
so a tree of relays carries many subscribers off one publisher with no
frame encoded twice."""

from k8s_watcher_tpu_torch.relay.plane import RelayPlane

__all__ = ["RelayPlane"]
