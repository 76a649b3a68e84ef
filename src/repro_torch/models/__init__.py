"""Dense decoder over the paged KV pool."""
