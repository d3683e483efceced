"""The operations and bytes of one unit of a driver's work, from the
configuration and the data's sizes alone: never from what the program
derived (padded classes, hot widths, graph nodes), so that a share reads
the same work whatever implements it. ``per_work(config, traffic, stats)``
returns (FLOPs, bytes); each input byte is counted read once and each
output byte written once."""
