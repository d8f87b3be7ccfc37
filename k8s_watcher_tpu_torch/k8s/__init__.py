"""The Kubernetes side of remediation: apiserver connection and a node client."""
