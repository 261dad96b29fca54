"""User entry points of the port (`dispatches-tpu-torch`)."""
