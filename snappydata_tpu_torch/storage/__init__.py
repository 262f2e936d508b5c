"""Column storage: encodings, batches, table store, device plates."""
