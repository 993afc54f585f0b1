"""Deployment of the port's server: the warm-lifecycle supervisor
(``launch``: one server, N replicas behind the router, or a lockstep group),
its least-loaded WS/HTTP front router (``router``) and the one warm build a
launch runs before any server starts (``warm_build``)."""
