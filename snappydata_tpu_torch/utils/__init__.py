"""Named locks and TPC-H data generation."""
