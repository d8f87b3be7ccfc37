"""Watch sources: the event record, the sharded ingest, the in-process fake."""
