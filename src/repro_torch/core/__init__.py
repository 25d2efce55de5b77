"""MoE core of the port: router, dispatcher (one rank) and MoE layer."""
