"""The notifier: the HTTP client of the cluster API and the async dispatcher."""
