"""Serving path of the port: the continuous-batching engine, its paged KV
allocator and error taxonomy, and the model server."""
