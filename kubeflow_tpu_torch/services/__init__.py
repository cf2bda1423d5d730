"""The port's platform services: the dashboard's monitoring views
(``dashboard``)."""
