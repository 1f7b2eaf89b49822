"""Program IR, executor and op registry of the port."""
