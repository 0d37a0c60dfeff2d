"""Federated training in one process."""
