"""Distribution: activation sharding context, parameter sharding rules."""
