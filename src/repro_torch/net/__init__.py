"""Network layer of the port: topology, paths, policies, engine."""
