"""Serving path of the port: the continuous-batching engine (speculative
decoding, prefill/decode roles), its paged KV allocator, the KV wire format
and error taxonomy, and the model server."""
