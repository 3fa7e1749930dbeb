"""Pipeline workers and the cluster of the port's serving stack."""
