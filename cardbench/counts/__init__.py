"""Operation and byte counts, computed from shapes and inputs, never from
the port: a share of a peak or of a roofline reads the same work whatever
implements it."""
