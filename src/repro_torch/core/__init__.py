"""Channels of the port: combiners, the channel context, routing, the
message/aggregator/scatter-combine channels and their composition."""
