"""Command-line tools of the port: GFA sorting, statistics, layout quality
and isomorphism (each takes ``--device`` where it runs device code), and the
kernel timing scripts, which need a GPU."""
